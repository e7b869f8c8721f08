// K4: the exact k-NN merge -- scores of query rows against candidate rows
// and each query row's running top-k, fused.
//
// Replaces the JAX package's `_knn_tiles_qc` (fedrann_tpu/knn/topk.py:146:
// a bf16 dot_general with float32 accumulation and lax.top_k inside a
// lax.scan over candidate blocks), which XLA compiles; no pl.pallas_call.
// It computes exactly knn/topk.py `merge_block_plain`: the int64 keys of
// _order_keys (the float32 score's bits made monotone in the high word,
// 0xFFFFFFFF - index in the low word), of the min(k, w + n) best of the
// carry's w keys and the n candidates' keys, sorted descending. The carry
// is sorted descending (merge_block's own output); its unset slots are
// EMPTY_KEY, below every key a score makes.
//
// Bound on the card: operations. The product is 2 * m * n * d operations:
// at precision bf16 over the tensor cores' 989 TFLOP/s (m = n = 15,000, d =
// 512: 0.23 ms), at fp32 over the FFMA pipe's 67 TFLOP/s. The bytes are
// the rows, read once, and m * k keys (~31 MB there: 0.009 ms).
//
// Design. One block owns BM = 128 query rows and walks all n candidates in
// tiles of BN = 128 inside the kernel (the loop that takes the place of the
// scan), so no (m, n) score or key tile reaches device memory. Eight warps,
// 4 x 2, each a 32 x 64 part of the tile. The depth is walked in stages of
// 128 bytes a row, three in flight in shared memory (cp.async groups; a
// step waits for its own stage while the next two load), one barrier a
// step:
//   - bf16: 64 values a stage, converted to bf16 as they are loaded
//     (lossless for bf16 rows and for float32 rows rounded to bf16 once,
//     topk.round_rows; round to nearest even otherwise, as round_rows does):
//     bf16 rows by cp.async, float32 rows through registers. Rows are
//     stored with their 16-byte chunks XOR-swizzled by the row, so the
//     ldmatrix reads of a fragment hit 32 distinct banks; the product is
//     mma.sync.m16n8k16 bf16 with float32 accumulation.
//   - fp32: 32 values a stage, stored transposed (depth-major, rows padded
//     by one word against bank conflicts); a thread owns 8 x 8 pairs and
//     accumulates with fmaf over the depth in order.
// Every pair's score is the same sequence of operations whatever its place
// in a tile, block, launch or card (a fixed loop over d in a fixed fragment
// layout, zero-padded past d to the stage depth), so in-core, out-of-core,
// sharded and multi-process searches score each pair bit-identically and
// their ties agree.
//
// The running top-k. A row's list (at most W = min(k, w + n) keys, sorted
// descending) lives in its row of the output in device memory, so k has no
// limit; its length and its W-th key (the threshold; EMPTY_KEY while the
// list is short) are in shared memory. After a tile's product, each of its
// two column halves is staged in shared memory (the stage buffer the
// tile's last step consumed) and scanned in a rolled loop, a thread a row
// and 32 columns: the scan builds each pair's key from the score's bits
// and keeps only those above the row's threshold (one integer compare for
// almost every pair past the first tiles), appending them to the row's
// survivor buffer (SV = 96 keys) by a shared-memory atomic. (Offering
// straight from the accumulators, unrolled over a thread's 64 pairs, cost
// several times the product; PERF.md.) A half adds at most 64 keys a row,
// and a row is merged only once its buffer holds more than SV - 64 (and at
// the end), so a merge takes a batch of survivors; meanwhile the threshold
// is merely lower than it could be. One warp a row sorts the survivors by rank (keys
// are distinct) and merges them into the list by rank: each element's
// place is its own index plus its rank in the other list. A list of at
// most LCAP = 128 keys is first copied into the warp's shared-memory
// scratch (one coalesced load), the ranks taken there and every key
// written to its place in device memory; a longer list merges in place,
// its old keys moving from the back to the front in warp-wide chunks, each
// read before it is written, so it needs no second buffer. Equal keys
// (EMPTY_KEY slots of the carry) are equal values, so their order does not
// show.
//
// Ragged m and n and any d are masked; m < BM leaves rows of the block
// idle. A zero row scores +0.0 against everything (the accumulators start
// at +0.0), so the lowest indices win its ties, as in the plain version.
// The launch is one block per BM query rows; 207,616 bytes of dynamic
// shared memory, one block an SM.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;          // query rows a block
constexpr int BN = 128;          // candidate rows a tile
constexpr int THREADS = 256;     // eight warps, 4 (rows) x 2 (candidates)
constexpr int STAGES = 3;        // depth stages in flight
constexpr int BK16 = 64;         // bf16 values a stage (128 bytes a row)
constexpr int BK32 = 32;         // float32 values a stage (128 bytes a row)
constexpr int A32 = BM + 1;      // transposed fp32 strides, padded
constexpr int B32 = BN + 1;
constexpr int ROUND = BN / 2;    // keys a row gains in a round at most
constexpr int SV = 96;           // survivor slots a row
constexpr int MERGE_AT = SV - ROUND;  // a row holding more merges
constexpr int LCAP = 128;        // lists merged through the warp's scratch
constexpr int WARPS = THREADS / 32;
constexpr int STAGE16 = (BM + BN) * BK16 * 2;
constexpr int STAGE32 = (A32 + B32) * BK32 * 4;
constexpr int STAGE_BYTES = STAGE32 > STAGE16 ? STAGE32 : STAGE16;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + BM * SV * 8
                           + WARPS * LCAP * 8 + BM * 16;
constexpr int FP_ROWS = THREADS / 16;  // fp32: a thread's row stride
static_assert(BM * ROUND * 4 <= STAGE_BYTES, "a half's scores fit a stage");
static_assert(THREADS == 2 * BM && ROUND == 64, "offer_half's layout");
constexpr int64_t EMPTY_KEY = INT64_MIN;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most STAGES - 2 groups are in flight: this step's landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint16_t to_bf16(uint16_t x) { return x; }

// _order_keys of one score: the high word is the float32 bits made
// monotone, the low word lo = 0xFFFFFFFF - index.
__device__ __forceinline__ int32_t mono_bits(float s) {
  const int32_t b = __float_as_int(s);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ int64_t make_key(int32_t mono, uint32_t lo) {
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(mono)) << 32) | lo);
}

// One bf16 stage of `rows` tile rows from global rows r0.. (of nrows) at
// depth k0: chunks of 8 values, chunk ch of row r at 16-byte slot ch ^ (r &
// 7) of the row's 128 bytes. Zeros past nrows and past d.
template <typename T>
__device__ __forceinline__ void load_stage16(uint16_t* dst, const T* src,
                                             int64_t r0, int64_t nrows,
                                             int rows, int64_t d, int64_t k0,
                                             bool vec) {
  for (int q = threadIdx.x; q < rows * 8; q += THREADS) {
    const int r = q >> 3, ch = q & 7;
    uint16_t* s = dst + r * BK16 + ((ch ^ (r & 7)) << 3);
    const int64_t gr = r0 + r, gk = k0 + ch * 8;
    if (gr < nrows && vec && gk + 8 <= d) {
      const T* g = src + gr * d + gk;
      if constexpr (sizeof(T) == 2) {
        cp_async16(s, g);
      } else {
        const float4 x = *reinterpret_cast<const float4*>(g);
        const float4 y = *reinterpret_cast<const float4*>(g + 4);
        uint4 v;
        v.x = to_bf16(x.x) | (static_cast<uint32_t>(to_bf16(x.y)) << 16);
        v.y = to_bf16(x.z) | (static_cast<uint32_t>(to_bf16(x.w)) << 16);
        v.z = to_bf16(y.x) | (static_cast<uint32_t>(to_bf16(y.y)) << 16);
        v.w = to_bf16(y.z) | (static_cast<uint32_t>(to_bf16(y.w)) << 16);
        *reinterpret_cast<uint4*>(s) = v;
      }
    } else {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t k = gk + 2 * u;
        const bool in = gr < nrows;
        const uint32_t lo = in && k < d ? to_bf16(src[gr * d + k]) : 0u;
        const uint32_t hi = in && k + 1 < d ? to_bf16(src[gr * d + k + 1])
                                            : 0u;
        v[u] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(s) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One fp32 stage, transposed: value (r, k0 + kk) at dst[kk * stride + r].
template <typename T>
__device__ __forceinline__ void load_stage32(float* dst, int stride,
                                             const T* src, int64_t r0,
                                             int64_t nrows, int rows,
                                             int64_t d, int64_t k0,
                                             bool vec) {
  for (int q = threadIdx.x; q < rows * 8; q += THREADS) {
    const int r = q >> 3, ch = q & 7;
    const int64_t gr = r0 + r, gk = k0 + ch * 4;
    float v[4];
    if (gr < nrows && vec && gk + 4 <= d) {
      const T* g = src + gr * d + gk;
      if constexpr (sizeof(T) == 2) {
        const uint2 x = *reinterpret_cast<const uint2*>(g);
        v[0] = __uint_as_float(x.x << 16);
        v[1] = __uint_as_float(x.x & 0xffff0000u);
        v[2] = __uint_as_float(x.y << 16);
        v[3] = __uint_as_float(x.y & 0xffff0000u);
      } else {
        const float4 x = *reinterpret_cast<const float4*>(g);
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = (gr < nrows && gk + u < d) ? to_f32(src[gr * d + gk + u])
                                          : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(ch * 4 + u) * stride + r] = v[u];
  }
}

// Number of leading entries of a[0, len), sorted descending, above v.
__device__ __forceinline__ int count_above(const int64_t* a, int len,
                                           int64_t v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Rows {
  int64_t* sv;       // [BM][SV] survivors since the row's last merge
  int64_t* scratch;  // [WARPS][LCAP] a merging warp's copy of a list
  int32_t* thr_hi;   // [BM] the threshold key's high word
  uint32_t* thr_lo;  // [BM] and low word
  int32_t* cnt;      // [BM] survivors since the row's last merge
  int32_t* len;      // [BM] the list's length
};

// The scores of one column half of a tile, staged for the scan in the
// stage buffer the tile's last step consumed: score (r, c) at float
// r * ROUND + (c ^ (r & 31)), so a warp's 32 rows read 32 banks.
__device__ __forceinline__ int score_at(int r, int c) {
  return r * ROUND + (c ^ (r & 31));
}

// Scan the staged half `half` of the tile at candidate col0: thread t
// takes row t % BM and 32 of the half's 64 columns. The 32 scores are read
// at once and tested against the row's threshold's high word into a mask;
// only the columns it sets (rare past the first tiles) build their keys,
// and each key above the threshold goes to the row's survivors.
__device__ __forceinline__ void offer_half(const Rows& rs, const float* sc,
                                           int half, int64_t row0,
                                           int64_t m, int64_t col0,
                                           int64_t n, int64_t first,
                                           const int64_t* ids) {
  const int r = threadIdx.x % BM;
  const int c0 = (threadIdx.x / BM) * 32;
  if (row0 + r >= m) return;
  const int32_t th = rs.thr_hi[r];
  const uint32_t tl = rs.thr_lo[r];
  const int64_t j0 = col0 + half * ROUND + c0;
  const int cols = n - j0 < 32 ? static_cast<int>(n - j0) : 32;
  uint32_t mask = 0;
#pragma unroll
  for (int cc = 0; cc < 32; ++cc) {
    const int32_t mono = mono_bits(sc[score_at(r, c0 + cc)]);
    mask |= static_cast<uint32_t>(mono >= th && cc < cols) << cc;
  }
  while (mask != 0) {
    const int cc = __ffs(mask) - 1;
    mask &= mask - 1;
    const int32_t mono = mono_bits(sc[score_at(r, c0 + cc)]);
    const int64_t index = ids != nullptr ? ids[j0 + cc] : first + j0 + cc;
    const uint32_t lo = 0xFFFFFFFFu - static_cast<uint32_t>(index);
    if (mono == th && lo <= tl) continue;
    const int slot = atomicAdd(&rs.cnt[r], 1);
    rs.sv[r * SV + slot] = make_key(mono, lo);
  }
}

// Sort row r's s survivors descending in place, by rank (distinct keys),
// by one warp.
__device__ __forceinline__ void sort_survivors(int64_t* S, int s, int lane) {
  int64_t v[SV / 32];
  int rank[SV / 32];
#pragma unroll
  for (int e = 0; e < SV / 32; ++e) {
    const int i = lane + 32 * e;
    rank[e] = -1;
    if (i < s) {
      v[e] = S[i];
      int above = 0;
#pragma unroll 8
      for (int t = 0; t < s; ++t) above += S[t] > v[e];
      rank[e] = above;
    }
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < SV / 32; ++e) {
    if (rank[e] >= 0) S[rank[e]] = v[e];
  }
  __syncwarp();
}

// The row's new threshold: the key at place W - 1 of its list.
__device__ __forceinline__ void set_threshold(const Rows& rs, int r,
                                              int64_t t) {
  rs.thr_hi[r] = static_cast<int32_t>(t >> 32);
  rs.thr_lo[r] = static_cast<uint32_t>(t);
}

// Merge row r's survivors into its list L (W slots in device memory), by
// one warp; then reset the row's count and set its length and threshold.
__device__ void merge_row(const Rows& rs, int r, int64_t* L, int W,
                          int lane, int64_t* scratch) {
  int64_t* S = rs.sv + r * SV;
  const int len = rs.len[r];
  if (W <= LCAP) {
    for (int i = lane; i < len; i += 32) scratch[i] = L[i];
  }
  sort_survivors(S, rs.cnt[r], lane);
  const int ns = min(rs.cnt[r], W);
  if (W <= LCAP) {
    // every key to its place, the ranks taken in the copies
#pragma unroll
    for (int e = 0; e < SV / 32; ++e) {
      const int i = lane + 32 * e;
      if (i < ns) {
        const int64_t x = S[i];
        const int p = i + count_above(scratch, len, x);
        if (p < W) L[p] = x;
        if (p == W - 1) set_threshold(rs, r, x);
      }
    }
    for (int i = lane; i < len; i += 32) {
      const int64_t x = scratch[i];
      const int p = i + count_above(S, ns, x);
      if (p < W && p != i) L[p] = x;
      if (p == W - 1) set_threshold(rs, r, x);
    }
  } else {
    // each new key's place in the merged list (read before any write)
    int place[SV / 32];
    int64_t v[SV / 32];
#pragma unroll
    for (int e = 0; e < SV / 32; ++e) {
      const int i = lane + 32 * e;
      place[e] = W;
      if (i < ns) {
        v[e] = S[i];
        place[e] = i + count_above(L, len, v[e]);
      }
    }
    const int i0 = count_above(L, len, S[0]);  // the first old key to move
    __syncwarp();
    // the old keys i0.. move back by their rank among the new, from the
    // back: a chunk's places are >= its own indices, so no key is written
    // before it has been read
    for (int hi = len; hi > i0; hi -= 32) {
      const int i = hi - 32 + lane;
      int64_t x = 0;
      int p = W;
      if (i >= i0) {
        x = L[i];
        p = i + count_above(S, ns, x);
      }
      __syncwarp();
      if (p < W) L[p] = x;
      __syncwarp();
    }
#pragma unroll
    for (int e = 0; e < SV / 32; ++e) {
      if (place[e] < W) L[place[e]] = v[e];
    }
    __syncwarp();
    if (lane == 0 && min(W, len + ns) == W) set_threshold(rs, r, L[W - 1]);
  }
  __syncwarp();
  if (lane == 0) {
    rs.len[r] = min(W, len + ns);
    rs.cnt[r] = 0;
  }
  __syncwarp();
}

// Merge every row of the block whose survivors number more than `above`.
__device__ __forceinline__ void merge_rows(const Rows& rs, int64_t* out,
                                           int64_t row0, int W, int above) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BM; r += WARPS) {
    if (rs.cnt[r] > above) {
      merge_row(rs, r, out + (row0 + r) * W, W, lane,
                rs.scratch + warp * LCAP);
    }
  }
}

// TC: the tensor-core (bf16) product, else the FFMA (fp32) product. T: the
// rows' type, float or bf16 bits (uint16_t).
template <bool TC, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    knn_merge_kernel(const T* __restrict__ q, int64_t m,
                     const T* __restrict__ c, int64_t n, int64_t d,
                     int64_t first, const int64_t* __restrict__ ids,
                     const int64_t* run, int64_t w, int W, int64_t* out,
                     bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rows rs;
  rs.sv = reinterpret_cast<int64_t*>(smem + STAGES * STAGE_BYTES);
  rs.scratch = rs.sv + BM * SV;
  rs.thr_hi = reinterpret_cast<int32_t*>(rs.scratch + WARPS * LCAP);
  rs.thr_lo = reinterpret_cast<uint32_t*>(rs.thr_hi + BM);
  rs.cnt = reinterpret_cast<int32_t*>(rs.thr_lo + BM);
  rs.len = rs.cnt + BM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;

  // the carry into the output rows (in place when out is run), and each
  // row's length and threshold
  for (int64_t e = threadIdx.x; e < BM * w; e += THREADS) {
    const int64_t r = e / w, col = e - r * w;
    if (row0 + r < m) out[(row0 + r) * W + col] = run[(row0 + r) * w + col];
  }
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool full = row0 + r < m && w == W && w > 0;
    const int64_t t = full ? run[(row0 + r) * w + w - 1] : EMPTY_KEY;
    rs.thr_hi[r] = static_cast<int32_t>(t >> 32);
    rs.thr_lo[r] = static_cast<uint32_t>(t);
    rs.cnt[r] = 0;
    rs.len[r] = row0 + r < m ? static_cast<int32_t>(w) : 0;
  }
  __syncthreads();

  constexpr int BK = TC ? BK16 : BK32;
  const int64_t kt_n = (d + BK - 1) / BK;
  const int64_t steps = ((n + BN - 1) / BN) * kt_n;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

  auto load = [&](int64_t step, int buf) {
    const int64_t tile = step / kt_n, k0 = (step - tile * kt_n) * BK;
    unsigned char* base = smem + buf * STAGE_BYTES;
    if constexpr (TC) {
      uint16_t* as = reinterpret_cast<uint16_t*>(base);
      load_stage16(as, q, row0, m, BM, d, k0, vec);
      load_stage16(as + BM * BK16, c, tile * BN, n, BN, d, k0, vec);
    } else {
      float* as = reinterpret_cast<float*>(base);
      load_stage32(as, A32, q, row0, m, BM, d, k0, vec);
      load_stage32(as + A32 * BK32, B32, c, tile * BN, n, BN, d, k0, vec);
    }
  };

  // the warp's place in the tile: rows wm * 32.., columns wn * 64..; for
  // the fp32 product a thread owns rows ty + FP_ROWS i and columns tx + 16 j
  const int wm = warp >> 1, wn = warp & 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) load(i, i);
    cp_async_commit();
  }
  int buf = 0;
  for (int64_t step = 0; step < steps; ++step) {
    cp_async_wait_stage();
    // every warp is past the step before, so its stage may be refilled
    __syncthreads();
    const int64_t ahead = step + STAGES - 1;
    if (ahead < steps) {
      load(ahead, buf == 0 ? STAGES - 1 : buf - 1);
    }
    cp_async_commit();
    unsigned char* base = smem + buf * STAGE_BYTES;
    buf = buf == STAGES - 1 ? 0 : buf + 1;
    if constexpr (TC) {
      const uint16_t* as = reinterpret_cast<const uint16_t*>(base);
      const uint16_t* bs = as + BM * BK16;
#pragma unroll
      for (int ks = 0; ks < BK16 / 16; ++ks) {
        uint32_t a[2][4], b[4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + (lane & 15);
          const int ch = 2 * ks + (lane >> 4);
          ldmatrix_x4(a[mi], as + r * BK16 + ((ch ^ (r & 7)) << 3));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int mat = lane >> 3;
          const int r = wn * 64 + np * 16 + ((mat >> 1) << 3) + (lane & 7);
          const int ch = 2 * ks + (mat & 1);
          ldmatrix_x4(b[np], bs + r * BK16 + ((ch ^ (r & 7)) << 3));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            mma_bf16(acc + (mi * 8 + ni) * 4, a[mi], b[ni >> 1][(ni & 1) * 2],
                     b[ni >> 1][(ni & 1) * 2 + 1]);
          }
        }
      }
    } else {
      const float* as = reinterpret_cast<const float*>(base);
      const float* bs = as + A32 * BK32;
#pragma unroll 4
      for (int kk = 0; kk < BK32; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = as[kk * A32 + ty + FP_ROWS * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = bs[kk * B32 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
          }
        }
      }
    }
    if ((step + 1) % kt_n != 0) continue;

    // the tile is scored: each column half is staged in the consumed
    // stage buffer (no warp reads it past this barrier, and it is refilled
    // only after the next step's), scanned, and its rows merged if full
    const int64_t col0 = (step / kt_n) * BN;
    float* sc = reinterpret_cast<float*>(base);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if constexpr (TC) {
        if (wn == half) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = wm * 32 + mi * 16 + (lane >> 2) + ((e >> 1) << 3);
                const int col = ni * 8 + ((lane & 3) << 1) + (e & 1);
                sc[score_at(r, col)] = acc[(mi * 8 + ni) * 4 + e];
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[score_at(ty + FP_ROWS * i, tx + 16 * j)] =
                acc[i * 8 + 4 * half + j];
          }
        }
      }
      __syncthreads();
      offer_half(rs, sc, half, row0, m, col0, n, first, ids);
      __syncthreads();
      merge_rows(rs, out, row0, W, MERGE_AT);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  }
  merge_rows(rs, out, row0, W, 0);
}

template <bool TC, typename T>
cudaError_t launch(const void* q, int64_t m, const void* c, int64_t n,
                   int64_t d, int64_t first, const int64_t* ids,
                   const int64_t* run, int64_t w, int64_t W, int64_t* out,
                   bool vec, cudaStream_t st) {
  auto kernel = knn_merge_kernel<TC, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((m + BM - 1) / BM);
  kernel<<<blocks, THREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(q), m, static_cast<const T*>(c), n, d, first,
      ids, run, w, static_cast<int>(W), out, vec);
  return cudaGetLastError();
}

}  // namespace

// The merge of knn/topk.py merge_block: q (m, d) and c (n, d) row-major,
// both float32 (is_bf16 = 0) or both bfloat16 (is_bf16 = 1); the
// candidates' indices are first + j, or ids[j] where ids is not null; run
// (m, w) int64 keys sorted descending, or w = 0; out (m, W) int64, W =
// min(k, w + n) >= w, may be run itself. fp32 = 0 multiplies in bf16 on
// the tensor cores, fp32 = 1 in float32 on the FFMA pipe. vec = 1 when d is
// a multiple of 8 and both row pointers are 16-byte aligned (16-byte
// loads). The block's shared-memory opt-in is set on the current device.
extern "C" int fk_knn_merge(const void* q, int64_t m, const void* c,
                            int64_t n, int64_t d, int is_bf16, int fp32,
                            int64_t first, const int64_t* ids,
                            const int64_t* run, int64_t w, int64_t W,
                            int64_t* out, int vec, void* stream) {
  if (m <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (W > INT32_MAX || w > W) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fp32) {
    err = is_bf16 ? launch<false, uint16_t>(q, m, c, n, d, first, ids, run,
                                            w, W, out, vec != 0, st)
                  : launch<false, float>(q, m, c, n, d, first, ids, run, w,
                                         W, out, vec != 0, st);
  } else {
    err = is_bf16 ? launch<true, uint16_t>(q, m, c, n, d, first, ids, run,
                                           w, W, out, vec != 0, st)
                  : launch<true, float>(q, m, c, n, d, first, ids, run, w,
                                        W, out, vec != 0, st);
  }
  return static_cast<int>(err);
}

