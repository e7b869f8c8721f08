// K6 and K7: the IVF search's exact rescore and its dedup merge.
//
// K6 (ivf_rescore_kernel, entry fk_ivf_rescore) replaces the JAX package's
// `_rescore_group` + `_scatter_group` (fedrann_tpu/knn/ivf.py:198, :219:
// per size class, a lax.map of gathered bf16 dot_generals with float32
// accumulation, top_k, and a scatter into the (query, probe slot) buffer),
// which XLA compiles; no pl.pallas_call. It computes knn/ivf.py
// `rescore_plain`'s buffer: for every probed cluster c and query slot j <
// qcounts[c] (query row first + qtab[c, j]), over the members i <
// counts[c] of c with member[c, i] < n_real, the int64 keys of
// _order_keys (the float32 score's bits made monotone in the high word,
// 0xFFFFFFFF - member index in the low word); the best min(W, members)
// of them, sorted descending, go to buf[qtab[c, j], stab[c, j], :] and
// the rest of its W slots to EMPTY_KEY. JAX's power-of-two size classes
// only pad with slots that are EMPTY_KEY either way, so K6 walks each
// cluster's true counts with masked tails.
//
// Bound on the card: operations, 2 * d * the real pair-scores (the sum
// over probed clusters of queries times members): at bf16 over the
// tensor cores' 989 TFLOP/s, at fp32 over the FFMA pipe's 67 TFLOP/s. The
// bytes are the query and member rows each unit gathers and the buffer.
//
// Design (simple first; the product and the running top-k are PR 13's K4,
// lifted). The host cuts the probed clusters into units of BM = 128 query
// slots (knn/ivf.py rescore_units: (cluster, first slot, slots, members),
// the clusters with the most members first); a block a unit, one an SM.
// Eight warps, 4 x 2, each a
// 32 x 64 part of a 128 x 128 tile of (query slot, member) pairs. The
// depth is walked in stages of 128 bytes a row, three in flight (cp.async
// groups, one barrier a step): the stage's query rows gathered by qtab,
// its member rows by member[c, :], each row of bf16 in eight 16-byte
// cp.async pieces (scalar loads where d % 8 != 0 or the base is not 16
// bytes aligned), zeros past the unit's slots, past its members, for a
// member >= n_real and past d.
//   - bf16: chunks of a row XOR-swizzled by the row, so the ldmatrix reads
//     of a fragment hit 32 distinct banks; mma.sync.m16n8k16 bf16 with
//     float32 accumulation.
//   - fp32: float32 rows stored transposed (depth-major, padded by one
//     word against bank conflicts), a thread 8 x 8 pairs, fmaf over the
//     depth in order.
// Every pair's score is one fixed sequence of operations whatever its
// place (d never split, sums from +0.0, zero-padded to the stage depth),
// so a row's score against a query is the same bits in every cluster that
// holds it, and the spill copies K7 removes are exact copies.
//
// The running top-k: a row's list (at most W keys, sorted descending)
// lives in its buffer row in device memory; its length and W-th key (the
// threshold; EMPTY_KEY while the list is short) in shared memory. After a
// tile's product each column half is staged in shared memory and scanned
// (a thread a row and 32 columns), keys above the threshold appended to
// the row's SV = 96 survivor slots; a row holding more than 32 is merged
// by one warp, by rank (keys are distinct: a cluster's members are).
// No atomics on results: each (query, slot) is one block's, so two
// launches write the same bytes. tools/k6_breakdown.py (the kernel rebuilt
// with the offers, the product or both switched off) shows the running
// top-k, not the product or the gathers, bounding this design: a unit
// sweeps only a few member tiles, so each list merges ~5 times and takes
// ~200 survivors (PERF.md).
//
// Resources, as ptxas -v gives them (sm_90a, the build log): the bf16 form
// 230 registers, the fp32 form 158, no spills; 209,664 bytes of dynamic
// shared memory (three 33 KB stages, 96 KB of survivors, 8 KB of merge
// scratch, the row states and query rows). K7 32 registers.
//
// K7 (ivf_merge_kernel, entry fk_ivf_merge) replaces the JAX package's
// `_merge_buffers` / `_dedup_topk` (fedrann_tpu/knn/ivf.py:227, :136) and
// the port's `merge_buffers_plain`: per query row, the p lists of W keys
// -> the best min(k, p W), sorted descending; with dedup (spill > 1)
// every key but the highest of each index dropped first. Each list must
// be sorted descending, as both rescores write it. Bound: bytes (the
// buffer read once, the result written once). A warp a row: the row's p W
// keys go to shared memory in one coalesced read; a lane holds the head
// of the lists l = lane, lane + 32, ...; each step the warp takes the
// largest head (the lowest list among equal keys), drops it if an index
// already taken has the same low word, else appends it; the owner lane
// advances that list. The keys come out in descending order, so the first
// copy of an index met is its highest, and the result is bitwise
// merge_buffers_plain's; EMPTY_KEY (the least key) ends the walk and
// fills the tail.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int64_t EMPTY_KEY = INT64_MIN;

// K6

constexpr int BM = 128;          // query slots a unit
constexpr int BN = 128;          // members a tile
constexpr int THREADS = 256;     // eight warps, 4 (rows) x 2 (members)
constexpr int STAGES = 3;        // depth stages in flight
constexpr int BK16 = 64;         // bf16 values a stage (128 bytes a row)
constexpr int BK32 = 32;         // float32 values a stage (128 bytes a row)
constexpr int A32 = BM + 1;      // transposed fp32 strides, padded
constexpr int B32 = BN + 1;
constexpr int ROUND = BN / 2;    // keys a row gains in a half at most
constexpr int SV = 96;           // survivor slots a row
constexpr int MERGE_AT = SV - ROUND;  // a row holding more merges
constexpr int LCAP = 128;        // lists merged through the warp's scratch
constexpr int WARPS = THREADS / 32;
constexpr int STAGE16 = (BM + BN) * BK16 * 2;
constexpr int STAGE32 = (A32 + B32) * BK32 * 4;
constexpr int STAGE_BYTES = STAGE32 > STAGE16 ? STAGE32 : STAGE16;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + BM * SV * 8
                           + WARPS * LCAP * 8 + BM * 16 + BM * 16;
constexpr int FP_ROWS = THREADS / 16;  // fp32: a thread's row stride
static_assert(BM * ROUND * 4 <= STAGE_BYTES, "a half's scores fit a stage");
static_assert(THREADS == 2 * BM && ROUND == 64, "offer_half's layout");

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

// The rows of a stage's tile are gathered: tile row r is global row
// row_of(r), or zeros where that is negative.
struct QueryRows {  // the unit's query slots
  const int64_t* row;  // [BM] in shared memory; -1 past the unit's slots
  __device__ int64_t operator()(int r) const { return row[r]; }
};

struct MemberRows {  // members t0 + r of the unit's cluster
  const int32_t* mem;  // member[c, :]
  int64_t t0, nm, n_real;
  __device__ int64_t operator()(int r) const {
    if (t0 + r >= nm) return -1;
    const int64_t i = __ldg(mem + t0 + r);
    return i < n_real ? i : -1;
  }
};

// One bf16 stage of `rows` gathered rows at depth k0: chunks of 8 values,
// chunk ch of row r at 16-byte slot ch ^ (r & 7) of the row's 128 bytes.
template <typename RowOf>
__device__ __forceinline__ void load_stage16(uint16_t* dst,
                                             const uint16_t* src,
                                             const RowOf& row_of, int rows,
                                             int64_t d, int64_t k0,
                                             bool vec) {
  for (int q = threadIdx.x; q < rows * 8; q += THREADS) {
    const int r = q >> 3, ch = q & 7;
    uint16_t* s = dst + r * BK16 + ((ch ^ (r & 7)) << 3);
    const int64_t gr = row_of(r), gk = k0 + ch * 8;
    if (gr >= 0 && vec && gk + 8 <= d) {
      cp_async16(s, src + gr * d + gk);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t k = gk + 2 * u;
        const uint32_t lo = gr >= 0 && k < d ? src[gr * d + k] : 0u;
        const uint32_t hi = gr >= 0 && k + 1 < d ? src[gr * d + k + 1] : 0u;
        v[u] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(s) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One fp32 stage, transposed: value (r, k0 + kk) at dst[kk * stride + r].
template <typename RowOf>
__device__ __forceinline__ void load_stage32(float* dst, int stride,
                                             const float* src,
                                             const RowOf& row_of, int rows,
                                             int64_t d, int64_t k0,
                                             bool vec) {
  for (int q = threadIdx.x; q < rows * 8; q += THREADS) {
    const int r = q >> 3, ch = q & 7;
    const int64_t gr = row_of(r), gk = k0 + ch * 4;
    float v[4];
    if (gr >= 0 && vec && gk + 4 <= d) {
      const float4 x = *reinterpret_cast<const float4*>(src + gr * d + gk);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = (gr >= 0 && gk + u < d) ? src[gr * d + gk + u] : 0.0f;
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
  int64_t* out;      // [BM] the row's list: its buffer row's offset
  int64_t* qrow;     // [BM] the row's query row in the rows, -1 if idle
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

// Scan the staged half `half` of the tile at member col0: thread t takes
// row t % BM and 32 of the half's 64 columns. The 32 scores are tested
// against the row's threshold's high word into a mask; only the columns
// it sets build their keys, and each key above the threshold of a member
// below n_real goes to the row's survivors.
__device__ __forceinline__ void offer_half(const Rows& rs, const float* sc,
                                           int half, int mq, int64_t col0,
                                           int64_t nm, const int32_t* mem,
                                           int64_t n_real) {
  const int r = threadIdx.x % BM;
  const int c0 = (threadIdx.x / BM) * 32;
  if (r >= mq) return;
  const int32_t th = rs.thr_hi[r];
  const uint32_t tl = rs.thr_lo[r];
  const int64_t j0 = col0 + half * ROUND + c0;
  const int cols = nm - j0 < 32 ? static_cast<int>(nm - j0) : 32;
  uint32_t mask = 0;
#pragma unroll
  for (int cc = 0; cc < 32; ++cc) {
    const int32_t mono = mono_bits(sc[score_at(r, c0 + cc)]);
    mask |= static_cast<uint32_t>(mono >= th && cc < cols) << cc;
  }
  while (mask != 0) {
    const int cc = __ffs(mask) - 1;
    mask &= mask - 1;
    const int64_t index = __ldg(mem + j0 + cc);
    if (index >= n_real) continue;
    const int32_t mono = mono_bits(sc[score_at(r, c0 + cc)]);
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

// Merge every row of the unit whose survivors number more than `above`.
__device__ __forceinline__ void merge_rows(const Rows& rs, int64_t* buf,
                                           int mq, int W, int above) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < mq; r += WARPS) {
    if (rs.cnt[r] > above) {
      merge_row(rs, r, buf + rs.out[r], W, lane, rs.scratch + warp * LCAP);
    }
  }
}

// TC: the tensor-core (bf16) product on bf16 rows, else the FFMA (fp32)
// product on float32 rows. units: (cluster, first slot, slots, members).
template <bool TC>
__global__ void __launch_bounds__(THREADS, 1)
    ivf_rescore_kernel(const void* __restrict__ rows_v, int64_t d,
                       const int32_t* __restrict__ member, int64_t m_all,
                       const int32_t* __restrict__ qtab,
                       const int32_t* __restrict__ stab, int64_t qm,
                       const int4* __restrict__ units, int64_t first,
                       int64_t n_real, int64_t p, int W, int64_t* buf,
                       bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rows rs;
  rs.sv = reinterpret_cast<int64_t*>(smem + STAGES * STAGE_BYTES);
  rs.scratch = rs.sv + BM * SV;
  rs.out = rs.scratch + WARPS * LCAP;
  rs.qrow = rs.out + BM;
  rs.thr_hi = reinterpret_cast<int32_t*>(rs.qrow + BM);
  rs.thr_lo = reinterpret_cast<uint32_t*>(rs.thr_hi + BM);
  rs.cnt = reinterpret_cast<int32_t*>(rs.thr_lo + BM);
  rs.len = rs.cnt + BM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4 unit = units[blockIdx.x];
  const int64_t c = unit.x, j0 = unit.y;
  const int mq = unit.z;
  const int64_t nm = unit.w;
  const int32_t* mem = member + c * m_all;

  for (int r = threadIdx.x; r < BM; r += THREADS) {
    if (r < mq) {
      const int64_t q = qtab[c * qm + j0 + r];
      rs.qrow[r] = first + q;
      rs.out[r] = (q * p + stab[c * qm + j0 + r]) * W;
    } else {
      rs.qrow[r] = -1;
      rs.out[r] = 0;
    }
    rs.thr_hi[r] = static_cast<int32_t>(EMPTY_KEY >> 32);
    rs.thr_lo[r] = 0u;
    rs.cnt[r] = 0;
    rs.len[r] = 0;
  }
  __syncthreads();

  constexpr int BK = TC ? BK16 : BK32;
  const int64_t kt_n = (d + BK - 1) / BK;
  const int64_t steps = ((nm + BN - 1) / BN) * kt_n;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

  const QueryRows q_of{rs.qrow};
  auto load = [&](int64_t step, int slot) {
    const int64_t tile = step / kt_n, k0 = (step - tile * kt_n) * BK;
    unsigned char* base = smem + slot * STAGE_BYTES;
    const MemberRows m_of{mem, tile * BN, nm, n_real};
    if constexpr (TC) {
      const uint16_t* src = static_cast<const uint16_t*>(rows_v);
      uint16_t* as = reinterpret_cast<uint16_t*>(base);
      load_stage16(as, src, q_of, BM, d, k0, vec);
      load_stage16(as + BM * BK16, src, m_of, BN, d, k0, vec);
    } else {
      const float* src = static_cast<const float*>(rows_v);
      float* as = reinterpret_cast<float*>(base);
      load_stage32(as, A32, src, q_of, BM, d, k0, vec);
      load_stage32(as + A32 * BK32, B32, src, m_of, BN, d, k0, vec);
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
  int b = 0;
  for (int64_t step = 0; step < steps; ++step) {
    cp_async_wait_stage();
    // every warp is past the step before, so its stage may be refilled
    __syncthreads();
    const int64_t ahead = step + STAGES - 1;
    if (ahead < steps) load(ahead, b == 0 ? STAGES - 1 : b - 1);
    cp_async_commit();
    unsigned char* base = smem + b * STAGE_BYTES;
    b = b == STAGES - 1 ? 0 : b + 1;
    if constexpr (TC) {
      const uint16_t* as = reinterpret_cast<const uint16_t*>(base);
      const uint16_t* bs = as + BM * BK16;
#pragma unroll
      for (int ks = 0; ks < BK16 / 16; ++ks) {
        uint32_t a[2][4], bf[4][4];
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
          ldmatrix_x4(bf[np], bs + r * BK16 + ((ch ^ (r & 7)) << 3));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            mma_bf16(acc + (mi * 8 + ni) * 4, a[mi],
                     bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
          }
        }
      }
    } else {
      const float* as = reinterpret_cast<const float*>(base);
      const float* bs = as + A32 * BK32;
#pragma unroll 4
      for (int kk = 0; kk < BK32; ++kk) {
        float a[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = as[kk * A32 + ty + FP_ROWS * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[kk * B32 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i * 8 + j] = fmaf(a[i], bv[j], acc[i * 8 + j]);
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
      offer_half(rs, sc, half, mq, col0, nm, mem, n_real);
      __syncthreads();
      merge_rows(rs, buf, mq, W, MERGE_AT);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  }
  merge_rows(rs, buf, mq, W, 0);
  __syncthreads();
  // the slots the members cannot fill
  for (int r = warp; r < mq; r += WARPS) {
    int64_t* L = buf + rs.out[r];
    for (int i = rs.len[r] + lane; i < W; i += 32) L[i] = EMPTY_KEY;
  }
}

template <bool TC>
cudaError_t launch_rescore(const void* rows, int64_t d,
                           const int32_t* member, int64_t m_all,
                           const int32_t* qtab, const int32_t* stab,
                           int64_t qm, const int4* units, int64_t n_units,
                           int64_t first, int64_t n_real, int64_t p, int W,
                           int64_t* buf, bool vec, cudaStream_t st) {
  auto kernel = ivf_rescore_kernel<TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_units), THREADS, SMEM_BYTES, st>>>(
      rows, d, member, m_all, qtab, stab, qm, units, first, n_real, p, W,
      buf, vec);
  return cudaGetLastError();
}

// K7

constexpr int WARPS_MAX = 8;       // warps a block, at most
constexpr int SMEM_TARGET = 48 << 10;  // a block's shared memory, aimed at

// The shared memory of a row's warp: the row's p L keys, its K results
// and its p list heads, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int64_t warp_bytes(int64_t p, int64_t L,
                                                       int64_t K) {
  return (p * L * 8 + K * 8 + p * 4 + 15) / 16 * 16;
}

__global__ void ivf_merge_kernel(const int64_t* __restrict__ buf,
                                 int64_t rows, int p, int L, int K,
                                 bool dedup, int64_t* __restrict__ out,
                                 int64_t per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                      + warp;
  if (row >= rows) return;  // no barrier of the block follows
  const int w = p * L;
  int64_t* keys = reinterpret_cast<int64_t*>(smem + warp * per_warp);
  int64_t* res = keys + w;
  int32_t* pos = reinterpret_cast<int32_t*>(res + K);
  const int64_t* src = buf + row * w;
  for (int i = lane; i < w; i += 32) keys[i] = src[i];
  for (int l = lane; l < p; l += 32) pos[l] = 0;
  __syncwarp();

  // the largest head of this lane's lists (the lowest list among equal
  // keys); a lane without a list holds (EMPTY_KEY, p)
  int64_t hk = EMPTY_KEY;
  int hl = p;
  auto rescan = [&]() {
    hk = EMPTY_KEY;
    hl = p;
    for (int l = lane; l < p; l += 32) {
      const int64_t h = pos[l] < L ? keys[l * L + pos[l]] : EMPTY_KEY;
      if (hl == p || h > hk) {
        hk = h;
        hl = l;
      }
    }
  };
  rescan();
  int taken = 0;
  while (taken < K) {
    int64_t bk = hk;
    int bl = hl;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t ok = __shfl_xor_sync(0xffffffffu, bk, o);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
      if (ok > bk || (ok == bk && ol < bl)) {
        bk = ok;
        bl = ol;
      }
    }
    if (bk == EMPTY_KEY) break;  // every list is spent
    bool dup = false;
    if (dedup) {
      const uint32_t lo = static_cast<uint32_t>(bk);
      bool hit = false;
      for (int i = lane; i < taken; i += 32) {
        hit |= static_cast<uint32_t>(res[i]) == lo;
      }
      dup = __any_sync(0xffffffffu, hit);
    }
    if (!dup) {
      if (lane == 0) res[taken] = bk;
      ++taken;
    }
    if ((bl & 31) == lane) {
      ++pos[bl];
      rescan();
    }
    __syncwarp();
  }
  int64_t* dst = out + row * K;
  for (int i = lane; i < K; i += 32) dst[i] = i < taken ? res[i] : EMPTY_KEY;
}

}  // namespace

// K6: the rescore of knn/ivf.py rescore_clusters. rows (R, d) row-major,
// bfloat16 (is_bf16 = 1: mma.sync) or float32 (FFMA); member (C, m_all)
// and qtab, stab (C, qm) int32; units (n_units, 4) int32 (cluster, first
// slot, slots <= 128, members); query slot j of cluster c is row first +
// qtab[c, j]; members >= n_real never win; buf (nq, p, W) int64, every
// (query, slot) list of a unit written whole. vec = 1 where d * itemsize is
// a multiple of 16 and rows is 16-byte aligned (16-byte loads). The
// block's shared-memory opt-in is set on the current device.
extern "C" int fk_ivf_rescore(const void* rows, int64_t d, int is_bf16,
                              const int32_t* member, int64_t m_all,
                              const int32_t* qtab, const int32_t* stab,
                              int64_t qm, const int32_t* units,
                              int64_t n_units, int64_t first, int64_t n_real,
                              int64_t p, int64_t W, int64_t* buf, int vec,
                              void* stream) {
  if (n_units <= 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || W > INT32_MAX || d <= 0 || p <= 0 || n_units > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* u = reinterpret_cast<const int4*>(units);
  const cudaError_t err =
      is_bf16 ? launch_rescore<true>(rows, d, member, m_all, qtab, stab, qm,
                                     u, n_units, first, n_real, p,
                                     static_cast<int>(W), buf, vec != 0, st)
              : launch_rescore<false>(rows, d, member, m_all, qtab, stab, qm,
                                      u, n_units, first, n_real, p,
                                      static_cast<int>(W), buf, vec != 0,
                                      st);
  return static_cast<int>(err);
}

// K7: the merge of knn/ivf.py merge_probe_lists. buf (rows, p, L) int64,
// each (row, slot) list sorted descending; out (rows, K) int64, K <= p L;
// dedup = 1 drops every key but the first (highest) of each index.
extern "C" int fk_ivf_merge(const int64_t* buf, int64_t rows, int64_t p,
                            int64_t L, int64_t K, int dedup, int64_t* out,
                            void* stream) {
  if (rows <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (p <= 0 || L <= 0 || K > p * L || p * L > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per = warp_bytes(p, L, K);
  if (per > limit) return static_cast<int>(cudaErrorInvalidValue);
  int64_t warps = SMEM_TARGET / per;
  warps = warps < 1 ? 1 : warps > WARPS_MAX ? WARPS_MAX : warps;
  const int64_t bytes = warps * per;
  err = cudaFuncSetAttribute(ivf_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (rows + warps - 1) / warps;
  ivf_merge_kernel<<<static_cast<unsigned>(blocks),
                     static_cast<unsigned>(warps * 32),
                     static_cast<size_t>(bytes),
                     static_cast<cudaStream_t>(stream)>>>(
      buf, rows, static_cast<int>(p), static_cast<int>(L),
      static_cast<int>(K), dedup != 0, out, per);
  return static_cast<int>(cudaGetLastError());
}
