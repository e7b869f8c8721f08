// Staged slots of one 1024-window block of a read, in O(1) operations per
// window for every k <= 31: the device function that kernel A
// (canonical_sample.cu) and kernel B's fused source (select_stage_rows.cu)
// share.
//
// It computes what the TPU kernel `canonical_and_sample` computes
// (bench/pallas_kernels.py:42, its pallas_call :128): the canonical code of
// every window, its strand, its validity and the sample_hash32 filter. It
// does not carry over that kernel's k-step window build (one roll and one
// shift-or per base per strand): it takes each window's code from a packed
// stream as the JAX package's packed codec does
// (fedrann_tpu/kmers/codec.py `canonical_window_codes_packed`).
//
// For window j of block b (windows [1024 b, 1024 b + 1024) of the row):
//  1. 66 threads each stage one chunk of 16 bases, [1024 b + 16 c, +16):
//     the block's 1024 bases and a halo of k - 1 <= 30, as one 32-bit word
//     of a 2-bit LSB-first stream (base j at bits 2j, the packed codec's
//     layout) and 16 bits of an invalid-base mask (bit j set for a base
//     that is not A, C, G or T, or lies past the row), both into shared
//     memory. Where the chunk comes from is the row's source (RowSource):
//     - bytes: an (R, L) uint8 matrix. The thread loads its 16 bases (one
//       16-byte load inside a 16-byte aligned row, else byte loads) and
//       packs them (pack_chunk); a base >= 4 is INVALID, and the packer
//       writes INVALID for mid-read N and padding alike;
//     - packed: the native packer's 2-bit stream (fastx_fill_bucket_packed:
//       base j at bits 2 (j % 4) of byte j / 4, so the row's 32-bit word q
//       IS stream word q) and the row's length. The thread loads word
//       64 b + c (one 4-byte load inside a 4-byte aligned row, else byte
//       loads) and masks the bases from the length on. Padding and N pack
//       as A (0): validity comes only from the length (the pipeline picks
//       this source for buckets without mid-read N);
//     - bits: the same stream word, and the row's 16 valid bits of that
//       chunk (bytes 2q and 2q + 1 of its valid-bits row), inverted, with
//       the bases past the row's L masked too;
//  2. the barrier that publishes the stage is a __syncthreads_or of "some
//     base is valid", on that mask: a block whose bases are all INVALID (a
//     row's tail past its read, an all-N row) skips the rest, every slot
//     PAD_SLOT;
//  3. v = stream bits [2j, 2j + 2k), a funnel shift of two stream words
//     (two of three for k > 16, 2k <= 62 bits);
//     rc = ~v & mask: the complement of the LSB-first stream is the
//       MSB-first reverse complement;
//     code = pairrev(v) >> (B - 2k), B = 32 for k <= 16 (one 32-bit word)
//       and 64 above: pairrev reverses the order of the 2-bit pairs (a bit
//       reversal, then the two bits of each pair swapped back), which turns
//       the LSB-first stream into the MSB-first forward code;
//     is_fwd = code <= rc (a palindrome counts as forward), canon =
//       min(code, rc), valid = mask bits [j, j + k) all zero (a funnel
//       shift of two mask words);
//  4. slot = (canon << 1) | is_fwd if valid and (keep_all or
//     sample_hash32(canon) < threshold), else PAD_SLOT: bitwise what
//     kmers/codec.py `_canonical_sample_plain` gives.
//
// What bounds it on the card is integer work, not bytes: one byte of bases
// in per window against the work below. chip_smoke.py reads both counts
// from this file for the bound it prints.
//
// *_INSTR: the instructions of the integer pipe (64 lanes an SM) a window
// needs, as sm_90a code does the work: a 3-input LOP3 or IADD3 is one (it
// merges an and with an or, or three xors), a 64-bit shift two (SHF.U64
// and SHF.HI); shifts left by a constant and multiplies are IMADs, which
// issue to the FMA pipe and are not counted (2 a window, 6 a hash, 11 a
// staged chunk, below the integer pipe's count, so they do not bound it);
// index arithmetic of the unrolled layout and values computed once per
// thread are not counted. This is the floor that chip_smoke.py's bound
// uses:
//   every window of a block with a valid base (k <= 16): the code 10 (funnel
//     shift, mask, rc = xor, BREV, the pair swap's shift, and, and-or,
//     the code's shift, compare, min), the strand bit 1 (select), the
//     validity 3 (row bound, mask funnel shift, test), the keep test 1,
//     the slot 4 (or, high word, 64-bit select); for k > 16 the code takes
//     21 (funnel shifts 2, masks 2, rc 2, BREV 2, the pair swap's shifts 3,
//     ands 2, and-ors 2, the code's shift 2, compare 2, min 2 selects);
//   and the source's staging, amortised over the block's 1024 windows
//     (66 chunks; rounded down): bytes 3 (52 instructions a chunk packed),
//     packed 0 (8 a chunk: the length mask), bits 0 (11 a chunk: the two
//     valid bytes joined and inverted, the length mask);
//   a valid window when not keep_all, besides: the hash, three fmix32 of 6
//     (three shifts, three xors), the two seed xors (for k > 16 the high
//     word's xor merges into a 3-input LOP3) and the threshold compare;
//     h1 ^ h2 merges with the last fmix32's first xor.
//
// *_OPS: the same work counted at the source, one per arithmetic, logic,
// shift, compare or select on a 32-bit value and two on a 64-bit value
// (so LOP3's merges and the FMA pipe are not seen); an upper figure,
// printed beside the bound:
//   every window of a block with a valid base: the stream shift 1, the
//     code (k <= 16: funnel shift 1, mask 1, rc 2, pairrev 6 and its shift
//     1, compare 1, min 1; k > 16: funnel shifts 2, mask 2, rc 4, pairrev
//     12 and its shift 2, compare 2, min 2), the validity test 6 (row
//     bound, mask shift, funnel shift, and, compare, and), the sampling
//     test 1, the slot 7 (64-bit shift and or, the strand bit, the 64-bit
//     select);
//   and the source's staging, amortised over 1024 windows (66 chunks;
//     rounded up): bytes 4 (64 operations a chunk), packed 1 (10: the
//     64-bit offset, two 64-bit compares, a shift, an and, two selects),
//     bits 1 (15: those and the two bytes' shift and or, not, and, or);
//   a valid window when not keep_all, besides: the hash, three fmix32 of 8
//     operations each, 3 xors (4 for k > 16) and the threshold compare.
#pragma once

#include <type_traits>

#include "common.cuh"

// a window: add the source's STAGE_*
constexpr int WINDOW_INSTR_NARROW = 10 + 1 + 3 + 1 + 4;  // k <= 16
constexpr int WINDOW_INSTR_WIDE = 21 + 1 + 3 + 1 + 4;    // k > 16
constexpr int STAGE_INSTR_BYTES = 3;
constexpr int STAGE_INSTR_PACKED = 0;
constexpr int STAGE_INSTR_BITS = 0;
constexpr int HASH_INSTR_NARROW = 3 * 6 + 2 + 1;
constexpr int HASH_INSTR_WIDE = 3 * 6 + 2 + 1;
constexpr int WINDOW_OPS_NARROW = 1 + 13 + 6 + 1 + 7;  // k <= 16
constexpr int WINDOW_OPS_WIDE = 1 + 26 + 6 + 1 + 7;    // k > 16
constexpr int STAGE_OPS_BYTES = 4;
constexpr int STAGE_OPS_PACKED = 1;
constexpr int STAGE_OPS_BITS = 1;
constexpr int HASH_OPS_NARROW = 3 * 8 + 3 + 1;
constexpr int HASH_OPS_WIDE = 3 * 8 + 4 + 1;

// 16-base chunks one block stages: its 1024 bases and a halo of k - 1 <= 30
constexpr int WINDOW_CHUNKS = (SELECT_BLOCK + 32) / 16;
// 16-base stream words a block advances
constexpr int BLOCK_WORDS = SELECT_BLOCK / 16;

// The row sources (WindowParams::src; kmers/codec.py SOURCES).
constexpr int SRC_BYTES = 0;
constexpr int SRC_PACKED = 1;
constexpr int SRC_BITS = 2;

// What every window of a launch shares.
struct WindowParams {
  // SRC_BYTES: (rows, length) uint8 base codes, >= 4 invalid;
  // SRC_PACKED, SRC_BITS: (rows, (length + 3) / 4) uint8 2-bit stream
  const uint8_t* bases;
  // SRC_PACKED: (rows,) int32 lengths; SRC_BITS: (rows, (length + 7) / 8)
  // uint8 valid bits; SRC_BYTES: unused
  const void* aux;
  int64_t length;
  int64_t stride;        // bytes a row of `bases`
  int64_t w;             // windows per row: length - k + 1
  int k;                 // 1..31
  uint32_t s1, s2;       // sample_hash32 seeds: fmix32(seed), fmix32(s1 ^ 0x9E3779B9)
  uint32_t threshold;
  int keep_all;
};

// One 16-base chunk as window_slots takes it: the chunk's word of the
// 2-bit LSB-first stream and its invalid mask (bit j: base j invalid).
struct WindowChunk {
  uint32_t word, bad;
};

// A block's packed bases in shared memory.
struct WindowStage {
  uint32_t stream[WINDOW_CHUNKS];       // 2 bits a base, 16 bases a word
  uint32_t invalid[WINDOW_CHUNKS / 2];  // 1 bit a base, 32 bases a word
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Chunk c (< WINDOW_CHUNKS) of block b of a row: bases [1024 b + 16 c,
// +16) as 16 bytes, INVALID past the row.
__device__ __forceinline__ uint4 load_window_chunk(const uint8_t* row,
                                                   int64_t length, int64_t b,
                                                   int c, bool aligned) {
  const int64_t off = b * SELECT_BLOCK + 16 * c;
  if (aligned && off + 16 <= length)
    return *reinterpret_cast<const uint4*>(row + off);
  uint32_t word[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    word[q] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = off + 4 * q + j;
      word[q] |= (i < length ? static_cast<uint32_t>(row[i]) : 4u) << (8 * j);
    }
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// 4 bases, one a byte (little-endian) -> *bits: 8 stream bits (base j at
// bits 2j), *bad: 4 mask bits (bit j: base j >= 4).
__device__ __forceinline__ void pack4(uint32_t x, uint32_t* bits,
                                      uint32_t* bad) {
  const uint32_t y = x & 0x03030303u;
  *bits = (y | (y >> 6) | (y >> 12) | (y >> 18)) & 0xFFu;
  // one 0xFF byte per base >= 4; the multiply gathers the bytes' low bits
  // into bits 24..27 (its other partial products land below bit 24 or past
  // bit 31, each on a bit of its own, so nothing carries)
  *bad = ((__vcmpgeu4(x, 0x04040404u) & 0x01010101u) * 0x01020408u) >> 24;
}

// 16 bases -> one stream word and 16 mask bits.
__device__ __forceinline__ void pack_chunk(uint4 c, uint32_t* word,
                                           uint32_t* bad) {
  const uint32_t x[4] = {c.x, c.y, c.z, c.w};
  *word = 0;
  *bad = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t bits, m;
    pack4(x[q], &bits, &m);
    *word |= bits << (8 * q);
    *bad |= m << (4 * q);
  }
}

// The invalid mask of 16 bases of which the first `left` lie in the row.
__device__ __forceinline__ uint32_t past_mask(int64_t left) {
  return left >= 16 ? 0u
         : left <= 0 ? 0xFFFFu
                     : (0xFFFFu << static_cast<int>(left)) & 0xFFFFu;
}

// Bytes [off, off + 4) of a row of `stride` bytes, little-endian, 0 past
// the row: one 4-byte load where the row is 4-byte aligned and holds all
// four, byte loads elsewhere.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row,
                                              int64_t stride, int64_t off,
                                              bool aligned) {
  if (aligned && off + 4 <= stride)
    return *reinterpret_cast<const uint32_t*>(row + off);
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (off + j < stride) x |= static_cast<uint32_t>(row[off + j]) << (8 * j);
  return x;
}

// A row's chunks, one struct per source: the row's source is built once a
// thread (its row pointers and length); fetch(b, c) loads chunk c of block
// b into the source's Raw form and chunk(raw) turns that into the chunk's
// (word, bad). The two are apart so that a caller may fetch the next
// block's chunk before it computes this block (the loads then land while
// it works); only the byte source does work in chunk() (pack_chunk).
template <int SRC>
struct RowSource;

template <>
struct RowSource<SRC_BYTES> {
  using Raw = uint4;  // 16 bases, one a byte
  const uint8_t* row;
  int64_t length;
  bool aligned;
  __device__ RowSource(const WindowParams& p, int64_t r)
      : row(p.bases + r * p.stride), length(p.length),
        aligned(aligned16(row)) {}
  __device__ Raw fetch(int64_t b, int c) const {
    return load_window_chunk(row, length, b, c, aligned);
  }
  __device__ static WindowChunk chunk(const Raw& x) {
    WindowChunk out;
    pack_chunk(x, &out.word, &out.bad);
    return out;
  }
};

template <>
struct RowSource<SRC_PACKED> {
  using Raw = WindowChunk;
  const uint8_t* row;
  int64_t stride, len;
  bool aligned;
  __device__ RowSource(const WindowParams& p, int64_t r)
      : row(p.bases + r * p.stride), stride(p.stride),
        len(static_cast<const int32_t*>(p.aux)[r]),
        aligned((reinterpret_cast<uintptr_t>(row) & 3) == 0) {
    if (len > p.length) len = p.length;
  }
  __device__ Raw fetch(int64_t b, int c) const {
    const int64_t q = b * BLOCK_WORDS + c;
    return {load_word(row, stride, 4 * q, aligned), past_mask(len - 16 * q)};
  }
  __device__ static WindowChunk chunk(const Raw& x) { return x; }
};

template <>
struct RowSource<SRC_BITS> {
  using Raw = WindowChunk;
  const uint8_t* row;
  const uint8_t* valid;
  int64_t stride, valid_stride, length;
  bool aligned;
  __device__ RowSource(const WindowParams& p, int64_t r)
      : row(p.bases + r * p.stride), stride(p.stride),
        valid_stride((p.length + 7) / 8), length(p.length),
        aligned((reinterpret_cast<uintptr_t>(row) & 3) == 0) {
    valid = static_cast<const uint8_t*>(p.aux) + r * valid_stride;
  }
  __device__ Raw fetch(int64_t b, int c) const {
    const int64_t q = b * BLOCK_WORDS + c;
    const uint32_t lo = 2 * q < valid_stride ? valid[2 * q] : 0u;
    const uint32_t hi = 2 * q + 1 < valid_stride ? valid[2 * q + 1] : 0u;
    return {load_word(row, stride, 4 * q, aligned),
            (~(lo | (hi << 8)) & 0xFFFFu) | past_mask(length - 16 * q)};
  }
  __device__ static WindowChunk chunk(const Raw& x) { return x; }
};

// x with the order of its 2-bit pairs reversed.
__device__ __forceinline__ uint32_t pairrev(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

__device__ __forceinline__ uint64_t pairrev(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) |
         ((x & 0x5555555555555555ull) << 1);
}

// Slots of this thread's PER windows PER * t + i of block b, into v.
// The threads that hold the block's chunks pass each its chunk index c
// and its chunk (RowSource::chunk of fetch(b, c)); the others pass c = -1.
// Every thread of the block calls it; it writes `stage`, waits at a
// barrier, then reads it, so a caller that stages the next block
// alternates two stages (or waits at a barrier between the calls).
template <int PER, bool WIDE>
__device__ __forceinline__ void window_slots(const WindowParams& p,
                                             int64_t b, int c,
                                             WindowChunk chunk,
                                             WindowStage& stage,
                                             int64_t (&v)[PER]) {
  static_assert(16 % PER == 0, "a thread's windows share their stream word");
  using Code = typename std::conditional<WIDE, uint64_t, uint32_t>::type;
  constexpr int BITS = 8 * sizeof(Code);
  int live = 0;
  if (c >= 0) {
    stage.stream[c] = chunk.word;
    reinterpret_cast<uint16_t*>(stage.invalid)[c] =
        static_cast<uint16_t>(chunk.bad);
    live = chunk.bad != 0xFFFFu;
  }
  if (!__syncthreads_or(live)) {  // every base INVALID: no valid window
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = PAD_SLOT;
    return;
  }
  // once per thread
  const int j0 = PER * threadIdx.x;  // the thread's first window
  const uint32_t w0 = stage.stream[j0 >> 4], w1 = stage.stream[(j0 >> 4) + 1];
  const uint32_t w2 = WIDE ? stage.stream[(j0 >> 4) + 2] : 0u;
  const uint32_t m0 = stage.invalid[j0 >> 5];
  const uint32_t m1 = stage.invalid[(j0 >> 5) + 1];
  const int s0 = 2 * (j0 & 15), t0 = j0 & 31;
  const uint32_t kmask = (1u << p.k) - 1u;
  const Code mask = ~Code(0) >> (BITS - 2 * p.k);
  const int shift = BITS - 2 * p.k;
  const int64_t left64 = p.w - (b * SELECT_BLOCK + j0);
  const int left = left64 < PER ? static_cast<int>(left64) : PER;
  const bool sample = !p.keep_all;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = s0 + 2 * i;  // <= 30
    Code x = __funnelshift_r(w0, w1, s);
    if constexpr (WIDE)
      x |= static_cast<Code>(__funnelshift_r(w1, w2, s)) << 32;
    x &= mask;
    const Code rc = ~x & mask;
    const Code code = pairrev(x) >> shift;
    const bool is_fwd = code <= rc;
    const Code canon = is_fwd ? code : rc;
    const bool valid =
        i < left && (__funnelshift_r(m0, m1, t0 + i) & kmask) == 0;
    bool keep = valid;
    if (valid && sample) {
      const uint32_t h1 = fmix32(static_cast<uint32_t>(canon) ^ p.s1);
      const uint32_t hi =
          WIDE ? static_cast<uint32_t>(static_cast<uint64_t>(canon) >> 32)
               : 0u;
      const uint32_t h2 = fmix32(hi ^ p.s2 ^ h1);
      keep = fmix32(h1 ^ h2) < p.threshold;
    }
    v[i] = keep ? static_cast<int64_t>((static_cast<uint64_t>(canon) << 1) |
                                       (is_fwd ? 1u : 0u))
                : PAD_SLOT;
  }
}
