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
// Work units. The query rows are cut into blocks of BM = 128 and the
// candidates into tiles of BN = 128; a unit is a query block times a
// contiguous range of tiles (its split: split s of U holds tiles [s T / U,
// (s + 1) T / U) of T). knn/topk.py `k4_units` chooses U from (m, n, k,
// the SM count) so that the units fill the card, and the grid is
// persistent: min(units, SMs) blocks, one an SM, each walking units u =
// blockIdx.x, + gridDim.x, ... (query block u % blocks, split u / blocks,
// so the blocks that run at once read the same candidates). A unit keeps
// its rows' lists in device memory: in the output when U = 1, else in the
// wrapper's scratch (U, m, W), padded with EMPTY_KEY; split 0 starts from
// the carry. A second kernel, knn_merge_combine, then takes each row's top
// W of its U lists (a warp a row, a lane a list). Keys are distinct, so
// the top W is one set and the result is bitwise the same for every U.
//
// bf16 (knn_merge_wgmma). Two consumer warpgroups of 64 query rows each,
// one producer warp and seven merge warps (512 threads: the merges, not
// the product, bound the kernel, so it takes as many merge warps as the
// registers allow). The producer keeps TMA loads in flight (chunks of 128
// rows x 64 values, 16 KB, 128-byte swizzled) through a ring of
// shared-memory stages, each with a full and an empty mbarrier. The
// consumers run wgmma.mma_async m64n128k16 bf16 -> f32, both operands
// K-major from shared memory (descriptors of the 128-byte swizzle: LBO
// 16 B, SBO 1 KB, the start advanced 32 B a k16 step), into 64 float
// registers a thread. The tensor maps are made on the host for each
// launch by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
// parameters; zero fill past m, n and d does the ragged edges. TMA needs
// 16-byte rows: knn/topk.py hands bf16 rows whose d is a multiple of 8
// and whose base is 16-byte aligned, making a zero-padded copy otherwise.
//
// Shared memory goes first to the top-k, then to the query tile. The
// unit's 128 query rows stay resident for the whole walk only where that
// leaves three stages beside the lists (at k = 50, d <= 192); else each
// stage carries the query chunk with the candidate chunk (32 KB a stage,
// three stages). Resident rows double the product's flops per staged byte,
// but k4_breakdown shows the merges, not the loads, holding the kernel
// back, and the lists and survivor halves that make the merges cheap take
// the room the query tile would.
//
// The filter on the accumulators. In wgmma's layout a thread holds two
// query rows (ra, ra + 8) of its warpgroup's 64 and 32 columns of each, so
// the four lanes of a quad hold a whole row and a warp 16 rows: a row
// belongs to one warp, and the filter needs no barrier of the warpgroup.
// After a tile's product a thread reads its rows' thresholds (the W-th key
// of the row's list; EMPTY_KEY while the list is short) and, for each
// group of 8 columns, compares the group's largest score of each row
// (max.NaN, so a NaN passes) once against the threshold as a float; only
// a group that passes builds keys (mono_bits, the equal-high-word index
// test) and appends those above the threshold to the row's survivors, an
// atomic slot in shared memory.
//
// The top-k, k <= 64: each row's list (sorted descending) stays in shared
// memory and its survivors go to one of two halves of 32 slots. Once the
// half being filled holds more than 16 keys and the other is free, the
// row's warp hands it to the merge warps (an entry in a shared-memory
// queue) and fills the other; a merge warp sorts the half (a warp-wide
// bitonic sort, a key a lane), takes the top 64 of it and the list (the
// larger of list[i] and survivors[63 - i], then a bitonic clean), keeps
// the first W, and publishes the new threshold. So the consumers append
// and go on while the merges run beside the product. A tile that would
// overflow a half is offered again in eight rounds of 16 columns a row,
// handing halves over between rounds; a consumer warp that has to wait for
// a half merges queue entries itself meanwhile, as it does at a unit's
// end, where it merges its rows' last halves and writes the lists out.
// k > 64 (knn_merge_wgmma<false>): the lists in device memory, 32 survivor
// slots a row, merged by the consumers (sort_survivors, merge_row: a list
// of at most LCAP = 128 keys ranked through the warp's scratch, a longer
// one merged in place, so k has no limit) behind the warpgroup's named
// barrier: the tile's keys are appended at once and the rows past 16
// merged after it, a tile that overflows offered again in rounds.
//
// fp32 (knn_merge_ffma): IEEE float32 products on the FFMA pipe (bound
// 67 TFLOP/s), in the same units, with the bf16 form's pipeline and top-k
// around an FFMA product. A producer warp keeps TMA loads of 128-byte
// chunk rows (32 float32, or 64 bfloat16 of bf16 rows) in flight, the
// candidate and the query chunk of each step in one 32 KB stage,
// 128-byte swizzled, through a ring on full and empty mbarriers; no
// thread loads or transposes a stage. Eight consumer warps own 16 query
// rows each, a thread two rows of them times eight (rows ra + 2 i) and
// eight candidate columns (tx + 16 j): 64 accumulators. Each step reads
// four consecutive depth values of its 8 query and 8 candidate rows, one
// 16-byte (8-byte for bf16) load each, and runs the 256 fmaf of the 64
// pairs over them in depth order. The swizzle spreads the rows a load
// reads over the bank groups (two query rows: one group each; 16
// candidate rows: two to a group, the least for 256 bytes), and its XOR
// folds into two base pointers and immediate offsets. After a tile, each
// thread tests each of its rows' largest score once against the row's
// threshold, in a loop over the rows (a row's scores picked out of the
// accumulators by selects, so the filter's code is not repeated eight
// times beside the live accumulators); the keys that pass go to the
// survivor halves and three merge warps of the shared-memory lists (W <=
// 64, the bf16 form's machinery), or to 32 slots a row merged into
// device-memory lists by the row's own warp (k > 64). A tile that would
// overflow is offered again in eight rounds of one column a thread. A
// warp owns its rows, so no barrier of the block stands in the product's
// way. Three merge warps: the most that keep the consumers at 168
// registers (12 warps, three to a scheduler; one or two merge warps leave
// the same 168, and are slower).
//
// One fixed sequence of operations a pair. d is never split: a pair's
// score is the same k16 steps (bf16) or fmaf chain (fp32) over the depth,
// zero-padded to the chunk, in whatever tile, unit, split, launch or card
// it falls, so in-core, out-of-core, sharded and multi-process searches
// score each pair bit-identically and their ties agree. Accumulators start
// at +0.0 in registers and every wgmma accumulates (scale-d = 1): a zero
// row scores +0.0 against everything (scale-d = 0 on the first step could
// give -0.0, which orders below +0.0 under mono_bits), so the lowest
// indices win its ties, as in the plain version.
//
// Resources, as ptxas -v gives them (nvcc 12.9, sm_90a; chip_smoke.py's
// phase 12 logs them from the build log): knn_merge_wgmma<true> 128
// registers (the cap at 512 threads) with 24 bytes of spill stores and 32
// of loads, <false> 128 registers, knn_merge_ffma 168 in each instance
// (the cap at 384 threads), with the spills phase 12 logs,
// knn_merge_combine 30, the others no spills; no static shared memory.
// Shared memory is dynamic: bf16 at d = 512 and k = 50 takes three 32 KB
// stages, 64 KB of survivor halves, 56 KB of lists, the row states and
// the queue (227,488 bytes); k > 64 the 128 KB query tile, three 16 KB
// stages, 32 KB of survivors, 8 KB of merge scratch and the row states
// (224,400 bytes); fp32 at k = 50 three 32 KB stages beside the same
// lists and halves (228,000 bytes), at k > 64 five stages beside 32
// survivor slots a row (208,528 bytes). One block an SM.

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "keys_sm90.cuh"

namespace {

constexpr int BM = 128;         // query rows a unit
constexpr int BN = 128;         // candidate rows a tile
constexpr int LCAP = 128;       // lists merged through the warp's scratch
constexpr int MAX_UNITS = 32;   // units a query block: a combine lane each

struct Rows {
  int64_t* sv;       // [BM][SV] survivors since the row's last merge
  int64_t* scratch;  // [warps][LCAP] a merging warp's copy of a list
  int32_t* thr_hi;   // [BM] the threshold key's high word
  uint32_t* thr_lo;  // [BM] and low word
  int32_t* cnt;      // [BM] survivors since the row's last merge
  int32_t* len;      // [BM] the list's length
};

// Sort row r's s survivors descending in place, by rank (distinct keys),
// by one warp.
template <int SV>
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
template <int SV>
__device__ void merge_row(const Rows& rs, int r, int64_t* L, int W,
                          int lane, int64_t* scratch) {
  int64_t* S = rs.sv + r * SV;
  const int len = rs.len[r];
  if (W <= LCAP) {
    for (int i = lane; i < len; i += 32) scratch[i] = L[i];
  }
  sort_survivors<SV>(S, rs.cnt[r], lane);
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

// Merge the block rows r0, r0 + step, .. < r1 whose survivors number more
// than `above`, a warp each; row r's list is L0 + (row0 + r) * W.
template <int SV>
__device__ __forceinline__ void merge_rows(const Rows& rs, int64_t* L0,
                                           int64_t row0, int W, int above,
                                           int r0, int r1, int step,
                                           int lane, int64_t* scratch) {
  for (int r = r0; r < r1; r += step) {
    if (rs.cnt[r] > above) {
      merge_row<SV>(rs, r, L0 + (row0 + r) * W, W, lane, scratch);
    }
  }
}

// A unit: query rows row0.. and candidate tiles [t_lo, t_hi) of its split.
struct Unit {
  int64_t row0, t_lo, t_hi;
  int split;
};

__device__ __forceinline__ Unit unit_at(int64_t u, int64_t blocks,
                                        int64_t tiles, int units) {
  Unit x;
  x.split = static_cast<int>(u / blocks);
  x.row0 = (u - x.split * blocks) * BM;
  x.t_lo = x.split * tiles / units;
  x.t_hi = (x.split + 1) * tiles / units;
  return x;
}

// Open block rows [r0, r1) of a unit, threads t.. of nt: split 0's carry
// into the rows' lists (block row r's at L + r * stride; copy false where
// they are the carry itself), each row's length, count and threshold (the
// carry's last key when it fills W).
__device__ void open_rows(const Rows& rs, const Unit& x, int64_t m,
                          const int64_t* run, int64_t w, int W, int64_t* L,
                          int stride, bool copy, int r0, int r1, int t,
                          int nt) {
  const int64_t cw = x.split == 0 ? w : 0;
  if (cw > 0 && copy) {
    for (int64_t e = t; e < (r1 - r0) * cw; e += nt) {
      const int64_t r = r0 + e / cw, col = e % cw;
      if (x.row0 + r < m) L[r * stride + col] = run[(x.row0 + r) * w + col];
    }
  }
  for (int r = r0 + t; r < r1; r += nt) {
    const int64_t g = x.row0 + r;
    const bool live = g < m;
    set_threshold(rs, r, live && cw == W ? run[g * w + w - 1] : EMPTY_KEY);
    rs.cnt[r] = 0;
    rs.len[r] = live ? static_cast<int32_t>(cw) : 0;
  }
}

// Pad the lists of block rows r0, r0 + step, .. < r1 past their lengths
// with EMPTY_KEY (a split's list may hold fewer than W keys), a warp a row.
__device__ __forceinline__ void pad_rows(const Rows& rs, int64_t* L0,
                                         int64_t row0, int64_t m, int W,
                                         int r0, int r1, int step,
                                         int lane) {
  for (int r = r0; r < r1; r += step) {
    if (row0 + r >= m) break;
    for (int i = rs.len[r] + lane; i < W; i += 32) {
      L0[(row0 + r) * W + i] = EMPTY_KEY;
    }
  }
}

// ---------------------------------------------------------------- bf16 --

namespace tc {

constexpr int KC = 64;                // depth a chunk: one 128-byte row
constexpr int CHUNK = BN * KC * 2;    // bytes of a chunk of 128 rows
constexpr int CONSUMERS = 2;          // warpgroups, 64 query rows each
constexpr int CWARPS = 4 * CONSUMERS;
constexpr int MERGERS = 7;            // merge warps (lists in shared memory)
constexpr int THREADS = (CWARPS + 1 + MERGERS) * 32;  // + the producer
constexpr int CW = 16;                // keys a row gains in a round at most
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 3;
constexpr int ALIGN = 1024;           // the 128-byte swizzle's atom
constexpr int WL_MAX = 64;            // lists kept in shared memory up to
// shared memory past the stages and the query tile, lists in device
// memory: 32 survivor slots a row, the merging warps' scratch, row
// states, mbarriers
constexpr int GLOBAL_BYTES = BM * 32 * 8 + CWARPS * LCAP * 8 + BM * 16 +
                             (2 * MAX_STAGES + 2) * 8;
static_assert(BM == 64 * CONSUMERS, "a warpgroup's 64 rows");

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(b)) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait past ~2^36
// cycles (half a minute) traps: a lost phase fails the launch instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 36)) __trap();
  }
}

// A box of the tensor map (x = depth, y = row) into shared memory,
// completing on the mbarrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
        "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// The warpgroup's named barrier (1 + warpgroup; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The warpgroup's barrier, returning whether any of its threads passed v.
__device__ __forceinline__ bool wg_any(bool v, int id) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(v)), "r"(id)
      : "memory");
  return r != 0;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A row's threshold in a thread's registers: the key's words and, for the
// first test, the float whose bits the high word orders (-inf below every
// score when the high word is EMPTY_KEY's; +inf, and a key no score
// passes, for a row past m).
struct Thr {
  int32_t hi;
  uint32_t lo;
  float f;
};

__device__ __forceinline__ Thr thr_of(int64_t key, bool live) {
  Thr t;
  if (!live) {
    t.hi = INT32_MAX;
    t.lo = UINT32_MAX;
    t.f = __int_as_float(0x7f800000);
    return t;
  }
  t.hi = static_cast<int32_t>(key >> 32);
  t.lo = static_cast<uint32_t>(key);
  const float f = __int_as_float(t.hi < 0 ? t.hi ^ 0x7fffffff : t.hi);
  t.f = f != f ? __int_as_float(0xff800000) : f;
  return t;
}

__device__ __forceinline__ Thr load_thr(const Rows& rs, int r, bool live) {
  return thr_of(make_key(rs.thr_hi[r], rs.thr_lo[r]), live);
}

// Offer the score v of block row r and candidate column col: if its key is
// above the row's threshold, count it in the row's survivors and store it
// where its slot is below SV. Returns the slot, or -1.
template <int SV>
__device__ __forceinline__ int offer(const Rows& rs, int r, const Thr& th,
                                     float v, int64_t col, int64_t c_end,
                                     int64_t first, const int64_t* ids) {
  if (v < th.f) return -1;
  const int32_t mono = mono_bits(v);
  if (mono < th.hi || col >= c_end) return -1;
  const int64_t index = ids != nullptr ? ids[col] : first + col;
  const uint32_t lo = 0xFFFFFFFFu - static_cast<uint32_t>(index);
  if (mono == th.hi && lo <= th.lo) return -1;
  const int slot = atomicAdd(&rs.cnt[r], 1);
  if (slot < SV) rs.sv[r * SV + slot] = make_key(mono, lo);
  return slot;
}

// Merge the warpgroup's rows r0 + w4, + 4, .. whose survivors number more
// than `above`, a warp each, into their lists in device memory (row r's at
// L0 + (row0 + r) * W).
template <int SV>
__device__ __forceinline__ void merge_wg(const Rows& rs, int64_t* L0,
                                         int64_t row0, int W, int above,
                                         int r0, int w4, int lane,
                                         int64_t* scratch) {
  for (int r = r0 + w4; r < r0 + 64; r += 4) {
    if (rs.cnt[r] > above) {
      merge_row<SV>(rs, r, L0 + (row0 + r) * W, W, lane, scratch);
    }
  }
}

// ------------------------------------------ bf16, lists in shared memory --
//
// Where W <= 64 each row's list stays in shared memory, its survivors go
// to one of two halves of SVH slots, and MERGERS warps of their own merge
// full halves while the consumers go on: a consumer warp hands a half
// over (a queue entry) once it holds more than SVH / 2 keys and the row's
// other half is free, and appends to the other half from then on. Rows
// are owned by warps (a warp's lanes hold all four columns quarters of
// its 16 rows), so the consumers' filter needs no barrier of the
// warpgroup.

constexpr int SVH = 32;      // survivor slots a half
constexpr int QCAP = 256;    // queue entries (a row has one half queued)

struct Ls {
  int64_t* sv;     // [BM][2][SVH] survivors, two halves a row
  int64_t* lists;  // [BM][wl] the lists, sorted descending
  int64_t* thr;    // [BM] the threshold key (the W-th, or EMPTY_KEY)
  int32_t* len;    // [BM] the list's length
  int32_t* cnt;    // [BM][2] keys in each half
  int32_t* act;    // [BM] the half the consumers append to
  int32_t* busy;   // [BM][2] a half queued or being merged
  int32_t* queue;  // [QCAP] 2 * row + half + 1; 0 an empty slot, -1 stop
  int32_t* ctl;    // [4] queue head, queue tail, consumer warps done
  int wl;
};

__host__ __device__ constexpr int ls_bytes(int wl) {
  return BM * 2 * SVH * 8 + BM * wl * 8 + BM * (8 + 4 + 8 + 4 + 8) +
         QCAP * 4 + 16 + (2 * MAX_STAGES + 2) * 8;
}

__device__ __forceinline__ int64_t ld_volatile(const int64_t* p) {
  return *reinterpret_cast<const volatile int64_t*>(p);
}

__device__ __forceinline__ int ld_volatile(const int32_t* p) {
  return *reinterpret_cast<const volatile int32_t*>(p);
}

// As offer, into half h of row r (slot stored below SVH).
__device__ __forceinline__ int offer_ls(const Ls& R, int r, int h,
                                        const Thr& th, float v, int64_t col,
                                        int64_t c_end, int64_t first,
                                        const int64_t* ids) {
  if (v < th.f) return -1;
  const int32_t mono = mono_bits(v);
  if (mono < th.hi || col >= c_end) return -1;
  const int64_t index = ids != nullptr ? ids[col] : first + col;
  const uint32_t lo = 0xFFFFFFFFu - static_cast<uint32_t>(index);
  if (mono == th.hi && lo <= th.lo) return -1;
  const int slot = atomicAdd(&R.cnt[2 * r + h], 1);
  if (slot < SVH) R.sv[(2 * r + h) * SVH + slot] = make_key(mono, lo);
  return slot;
}

// Merge half h of row r into its list (W <= 64 keys), by one warp: the
// survivors sorted (sort32), then the top 64 of the list and them (the
// larger of list[i] and survivors[63 - i]: a bitonic sequence) sorted by
// a bitonic clean; the first W kept, the threshold the W-th once there
// are W, the half emptied.
__device__ void merge_half(const Ls& R, int r, int h, int W, int lane) {
  const int s = min(R.cnt[2 * r + h], SVH);
  const int64_t* S = R.sv + (2 * r + h) * SVH;
  const int64_t v = sort32(lane < s ? S[lane] : EMPTY_KEY, lane);
  int64_t* L = R.lists + r * R.wl;
  const int len = R.len[r];
  int64_t b0 = lane < len ? L[lane] : EMPTY_KEY;
  int64_t b1 = lane + 32 < len ? L[lane + 32] : EMPTY_KEY;
  b1 = kmax(b1, __shfl_sync(0xffffffffu, v, 31 - lane));
  const int64_t hi = kmax(b0, b1);
  b1 = kmin(b0, b1);
  b0 = hi;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const int64_t p0 = __shfl_xor_sync(0xffffffffu, b0, j);
    const int64_t p1 = __shfl_xor_sync(0xffffffffu, b1, j);
    const bool lower = (lane & j) == 0;
    if ((p0 > b0) == lower) b0 = p0;
    if ((p1 > b1) == lower) b1 = p1;
  }
  __syncwarp();
  if (lane < W) L[lane] = b0;
  if (lane + 32 < W) L[lane + 32] = b1;
  const int nl = min(W, len + s);
  const int64_t last = __shfl_sync(0xffffffffu, W <= 32 ? b0 : b1,
                                   (W - 1) & 31);
  if (lane == 0) {
    R.len[r] = nl;
    R.thr[r] = nl == W ? last : EMPTY_KEY;
    R.cnt[2 * r + h] = 0;
  }
  __syncwarp();
}

// Hand half a of row r to the merge warps (by the row's lane): the
// consumers append to the other half from now on.
__device__ __forceinline__ void hand_over(const Ls& R, int r, int a) {
  R.busy[2 * r + a] = 1;
  R.act[r] = a ^ 1;
  __threadfence_block();
  const int slot = atomicAdd(&R.ctl[0], 1);
  *reinterpret_cast<volatile int32_t*>(&R.queue[slot % QCAP]) =
      2 * r + a + 1;
}

// Take one queue entry where there is one not yet taken and merge it, by
// one warp (a consumer warp that waits on the merge warps helps them so).
// Returns whether it merged one.
__device__ bool try_merge(const Ls& R, int W, int lane) {
  int e = 0;
  if (lane == 0) {
    int t = ld_volatile(&R.ctl[1]);
    while (t < ld_volatile(&R.ctl[0])) {
      const int got = atomicCAS(&R.ctl[1], t, t + 1);
      if (got == t) {
        // the entry's push has taken its slot; its write follows
        while ((e = ld_volatile(&R.queue[t % QCAP])) == 0) {
        }
        *reinterpret_cast<volatile int32_t*>(&R.queue[t % QCAP]) = 0;
        break;
      }
      t = got;
    }
  }
  e = __shfl_sync(0xffffffffu, e, 0);
  if (e <= 0) return false;
  __threadfence_block();
  const int r = (e - 1) >> 1, h = (e - 1) & 1;
  merge_half(R, r, h, W, lane);
  __threadfence_block();
  __syncwarp();
  if (lane == 0) *reinterpret_cast<volatile int32_t*>(&R.busy[2 * r + h]) = 0;
  return true;
}

// Hand over the halves of the warp's rows r0w .. r0w + 15 that hold more
// than `limit` keys where the row's other half is free (a lane a row).
// Returns whether a row stays above the limit (its other half busy).
__device__ __forceinline__ bool hand_over_rows(const Ls& R, int r0w,
                                               int lane, int limit) {
  bool over = false;
  if (lane < 16) {
    const int r = r0w + lane, a = R.act[r];
    if (R.cnt[2 * r + a] > limit) {
      if (ld_volatile(&R.busy[2 * r + (a ^ 1)]) == 0) {
        hand_over(R, r, a);
      } else {
        over = true;
      }
    }
  }
  return __any_sync(0xffffffffu, over);
}

// Hand over the warp's halves past `limit` until none is left, merging
// queue entries meanwhile.
__device__ __forceinline__ void make_room(const Ls& R, int r0w, int lane,
                                          int W, int limit) {
  __threadfence_block();
  __syncwarp();
  while (hand_over_rows(R, r0w, lane, limit)) {
    if (!try_merge(R, W, lane)) __nanosleep(32);
  }
  __syncwarp();
}

// Wait until no half of the warp's rows r0w .. r0w + 15 is at the merge
// warps, merging queue entries meanwhile.
__device__ __forceinline__ void wait_idle(const Ls& R, int r0w, int lane,
                                          int W) {
  const int r = r0w + (lane & 15);
  while (__any_sync(0xffffffffu, (ld_volatile(&R.busy[2 * r]) |
                                  ld_volatile(&R.busy[2 * r + 1])) != 0)) {
    if (!try_merge(R, W, lane)) __nanosleep(32);
  }
  __threadfence_block();
}

// Open the warp's rows r0w .. r0w + 15 of unit x, lists in shared memory:
// split 0's carry into the lists, lengths, thresholds (the carry's last key
// where it fills W), empty halves.
__device__ __forceinline__ void open_ls_rows(const Ls& R, const Unit& x,
                                             int64_t m, const int64_t* run,
                                             int64_t w, int W, int r0w,
                                             int lane) {
  const int64_t cw = x.split == 0 ? w : 0;
  for (int i = lane; i < 16 * cw; i += 32) {
    const int r = r0w + i / static_cast<int>(cw);
    const int col = i % static_cast<int>(cw);
    if (x.row0 + r < m) {
      R.lists[r * R.wl + col] = run[(x.row0 + r) * w + col];
    }
  }
  if (lane < 16) {
    const int r = r0w + lane;
    const int64_t g = x.row0 + r;
    R.thr[r] = g < m && cw == W ? run[g * w + w - 1] : EMPTY_KEY;
    R.len[r] = g < m ? static_cast<int32_t>(cw) : 0;
    R.cnt[2 * r] = R.cnt[2 * r + 1] = 0;
    R.act[r] = 0;
    R.busy[2 * r] = R.busy[2 * r + 1] = 0;
  }
  __syncwarp();
}

// Close the warp's rows of unit x: back from the merge warps, their last
// halves merged here, and the lists written out (row r's at L0 + (row0 +
// r) * W, padded with EMPTY_KEY).
__device__ __forceinline__ void close_ls_rows(const Ls& R, const Unit& x,
                                              int64_t m, int W, int64_t* L0,
                                              int r0w, int lane) {
  __threadfence_block();
  __syncwarp();
  wait_idle(R, r0w, lane, W);
  for (int r = r0w; r < r0w + 16; ++r) {
    const int h = R.act[r];
    if (R.cnt[2 * r + h] > 0) merge_half(R, r, h, W, lane);
    if (x.row0 + r < m) {
      for (int i = lane; i < W; i += 32) {
        L0[(x.row0 + r) * W + i] =
            i < R.len[r] ? R.lists[r * R.wl + i] : EMPTY_KEY;
      }
    }
  }
  __syncwarp();
}

// A merge warp: each queue entry in turn, until a stop entry.
__device__ __forceinline__ void merge_loop(const Ls& R, int W, int lane) {
  while (true) {
    int t = 0;
    if (lane == 0) t = atomicAdd(&R.ctl[1], 1);
    t = __shfl_sync(0xffffffffu, t, 0) % QCAP;
    int e;
    while ((e = ld_volatile(&R.queue[t])) == 0) __nanosleep(64);
    __syncwarp();
    if (lane == 0) *reinterpret_cast<volatile int32_t*>(&R.queue[t]) = 0;
    if (e < 0) return;
    __threadfence_block();
    const int r = (e - 1) >> 1, h = (e - 1) & 1;
    merge_half(R, r, h, W, lane);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) {
      *reinterpret_cast<volatile int32_t*>(&R.busy[2 * r + h]) = 0;
    }
  }
}

// The last of `cwarps` consumer warps to finish stops the `mergers` merge
// warps (by its lane 0).
__device__ __forceinline__ void stop_mergers(const Ls& R, int cwarps,
                                             int mergers, int lane) {
  if (lane == 0 && atomicAdd(&R.ctl[2], 1) == cwarps - 1) {
    for (int i = 0; i < mergers; ++i) {
      const int slot = atomicAdd(&R.ctl[0], 1);
      *reinterpret_cast<volatile int32_t*>(&R.queue[slot % QCAP]) = -1;
    }
  }
}

}  // namespace tc

// LS: the rows' lists in shared memory with the merge warps (W <= 64);
// else in device memory, SV survivor slots a row, merged by the consumers
// through each warp's scratch.
template <bool LS>
__global__ void __launch_bounds__(tc::THREADS, 1)
    knn_merge_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tcand, int64_t m,
                    int64_t n, int kt_n, int64_t first,
                    const int64_t* __restrict__ ids, const int64_t* run,
                    int64_t w, int W, int64_t* out, int64_t* parts,
                    int units, int stages, int resident, int wl) {
  using namespace tc;
  // (device-memory lists) a tile's fast offer adds at most SV - MERGE_AT
  // keys a row before it overflows; rows above MERGE_AT merge after it
  constexpr int SV = 32;
  constexpr int MERGE_AT = SV / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const int stage_bytes = resident ? CHUNK : 2 * CHUNK;
  unsigned char* stage0 = base;
  unsigned char* qs = base + stages * stage_bytes;
  unsigned char* tail = qs + (resident ? kt_n * CHUNK : 0);
  Rows rs = {};
  Ls R = {};
  uint64_t* full;
  if constexpr (LS) {
    R.sv = reinterpret_cast<int64_t*>(tail);
    R.lists = R.sv + BM * 2 * SVH;
    R.thr = R.lists + BM * wl;
    R.len = reinterpret_cast<int32_t*>(R.thr + BM);
    R.cnt = R.len + BM;
    R.act = R.cnt + 2 * BM;
    R.busy = R.act + BM;
    R.queue = R.busy + 2 * BM;
    R.ctl = R.queue + QCAP;
    R.wl = wl;
    full = reinterpret_cast<uint64_t*>(R.ctl + 4);
  } else {
    rs.sv = reinterpret_cast<int64_t*>(tail);
    rs.scratch = rs.sv + BM * SV;
    rs.thr_hi = reinterpret_cast<int32_t*>(rs.scratch + CWARPS * LCAP);
    rs.thr_lo = reinterpret_cast<uint32_t*>(rs.thr_hi + BM);
    rs.cnt = reinterpret_cast<int32_t*>(rs.thr_lo + BM);
    rs.len = rs.cnt + BM;
    full = reinterpret_cast<uint64_t*>(rs.len + BM);
  }
  uint64_t* empty = full + stages;
  uint64_t* qfull = empty + stages;
  uint64_t* qempty = qfull + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (LS) {
    for (int i = threadIdx.x; i < QCAP + 4; i += THREADS) R.queue[i] = 0;
  }
  __syncthreads();

  const int64_t blocks = (m + BM - 1) / BM, tiles = (n + BN - 1) / BN;
  const int64_t total = blocks * units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0, qj = 0;

  if (warp == CWARPS) {
    // the producer: the unit's query tile (once, where resident), then
    // its candidate chunks through the ring
    if (lane != 0) return;
    for (int64_t u = blockIdx.x; u < total; u += gridDim.x) {
      const Unit x = unit_at(u, blocks, tiles, units);
      if (x.t_lo == x.t_hi) continue;
      if (resident) {
        mbar_wait(qempty, (qj & 1) ^ 1);
        mbar_expect_tx(qfull, kt_n * CHUNK);
        for (int kc = 0; kc < kt_n; ++kc) {
          tma_load(qs + kc * CHUNK, &tq, kc * KC, static_cast<int>(x.row0),
                   qfull);
        }
        ++qj;
      }
      for (int64_t t = x.t_lo; t < x.t_hi; ++t) {
        for (int kc = 0; kc < kt_n; ++kc) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, stage_bytes);
          unsigned char* sp = stage0 + stage * stage_bytes;
          tma_load(sp, &tcand, kc * KC, static_cast<int>(t * BN),
                   full + stage);
          if (!resident) {
            tma_load(sp + CHUNK, &tq, kc * KC, static_cast<int>(x.row0),
                     full + stage);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    // stay until the consumers have released every stage (every load done)
    for (int s = 0; s < stages; ++s) {
      mbar_wait(empty + stage, phase ^ 1);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  if (warp > CWARPS) {
    // the merge warps: each queue entry in turn, until a stop entry
    if constexpr (LS) merge_loop(R, W, lane);
    return;
  }

  // the consumers: warpgroup wg owns block rows wg * 64 ..; this thread
  // holds rows ra and rb = ra + 8 of wgmma's accumulator layout, and its
  // warp all four column quarters of rows r0w .. r0w + 15
  const int wg = warp >> 2, wt = threadIdx.x & 127, w4 = warp & 3;
  const int bar = 1 + wg, r0 = wg * 64, r0w = r0 + w4 * 16;
  const int ra = r0w + (lane >> 2), rb = ra + 8;
  const bool lead = (lane & 3) == 0;
  int64_t* scratch = rs.scratch + warp * LCAP;
  for (int64_t u = blockIdx.x; u < total; u += gridDim.x) {
    const Unit x = unit_at(u, blocks, tiles, units);
    int64_t* L0 = units == 1 ? out : parts + x.split * m * W;
    const bool live_a = x.row0 + ra < m, live_b = x.row0 + rb < m;
    Thr ta, tb;
    if constexpr (LS) {
      open_ls_rows(R, x, m, run, w, W, r0w, lane);
    } else {
      open_rows(rs, x, m, run, w, W, L0 + x.row0 * W, W, L0 != run, r0,
                r0 + 64, wt, 128);
      wg_sync(bar);
      ta = load_thr(rs, ra, live_a);
      tb = load_thr(rs, rb, live_b);
    }
    if (x.t_lo < x.t_hi) {
      if (resident) mbar_wait(qfull, qj & 1);
      const int64_t c_end = min(x.t_hi * BN, n);
      for (int64_t t = x.t_lo; t < x.t_hi; ++t) {
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
        fence_acc(acc);
        int prev = -1;
        for (int kc = 0; kc < kt_n; ++kc) {
          mbar_wait(full + stage, phase);
          const unsigned char* sp = stage0 + stage * stage_bytes;
          const unsigned char* a =
              (resident ? qs + kc * CHUNK : sp + CHUNK) + wg * 64 * 128;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks) {
            wgmma_m64n128k16(acc, desc_sw128(a + 32 * ks),
                             desc_sw128(sp + 32 * ks));
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (prev >= 0 && wt == 0) mbar_arrive(empty + prev);
          prev = stage;
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (wt == 0) {
          mbar_arrive(empty + prev);
          if (resident && t + 1 == x.t_hi) mbar_arrive(qempty);
        }

        // the filter: each row's largest score against its threshold
        const int64_t col0 = t * BN + (lane & 3) * 2;
        if constexpr (LS) {
          ta = thr_of(ld_volatile(&R.thr[ra]), live_a);
          tb = thr_of(ld_volatile(&R.thr[rb]), live_b);
          const int ha = R.act[ra], hb = R.act[rb];
          const int ca = R.cnt[2 * ra + ha], cb = R.cnt[2 * rb + hb];
          // the tile's keys above the thresholds, at once: each group of
          // 8 columns (two values of each row) offered only where one of
          // its values passes the first test
          int most = -1;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (__builtin_expect(
                    !(max_nan(acc[4 * j], acc[4 * j + 1]) < ta.f) ||
                        !(max_nan(acc[4 * j + 2], acc[4 * j + 3]) < tb.f),
                    0)) {
#pragma unroll
              for (int i = 4 * j; i < 4 * j + 4; ++i) {
                most = max(most, offer_ls(R, (i & 2) ? rb : ra,
                                          (i & 2) ? hb : ha,
                                          (i & 2) ? tb : ta, acc[i],
                                          col0 + j * 8 + (i & 1), c_end,
                                          first, ids));
              }
            }
          }
          if (!__any_sync(0xffffffffu, most >= 0)) continue;
          if (__any_sync(0xffffffffu, most >= SVH)) {
            // a half overflowed: drop the tile's keys and offer the tile
            // in eight rounds of 16 columns a row, each after the halves
            // with more than SVH - 16 keys are handed over (waiting for,
            // and helping with, the merges that free the other halves)
            if (lead) {
              R.cnt[2 * ra + ha] = ca;
              R.cnt[2 * rb + hb] = cb;
            }
#pragma unroll
            for (int round = 0; round < 8; ++round) {
              make_room(R, r0w, lane, W, SVH - 16);
              const int ra_h = R.act[ra], rb_h = R.act[rb];
              ta = thr_of(ld_volatile(&R.thr[ra]), live_a);
              tb = thr_of(ld_volatile(&R.thr[rb]), live_b);
#pragma unroll
              for (int i = 8 * round; i < 8 * round + 8; ++i) {
                offer_ls(R, (i & 2) ? rb : ra, (i & 2) ? rb_h : ra_h,
                         (i & 2) ? tb : ta, acc[i],
                         col0 + (i >> 2) * 8 + (i & 1), c_end, first, ids);
              }
            }
          }
          // hand the halves past SVH / 2 to the merge warps where the
          // row's other half is free (else the half fills on, and a tile
          // that overflows it waits for the other)
          __threadfence_block();
          __syncwarp();
          hand_over_rows(R, r0w, lane, SVH / 2);
          __syncwarp();
        } else {
          const int ca = rs.cnt[ra], cb = rs.cnt[rb];
          float ma = acc[0], mb = acc[2];
#pragma unroll
          for (int i = 0; i < 64; i += 4) {
            ma = max_nan(ma, max_nan(acc[i], acc[i + 1]));
            mb = max_nan(mb, max_nan(acc[i + 2], acc[i + 3]));
          }
          if (!wg_any(!(ma < ta.f) || !(mb < tb.f), bar)) continue;
          // the tile's keys above the thresholds, at once
          int most = -1;
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            most = max(most, offer<SV>(rs, (i & 2) ? rb : ra,
                                       (i & 2) ? tb : ta, acc[i],
                                       col0 + (i >> 2) * 8 + (i & 1), c_end,
                                       first, ids));
          }
          if (!wg_any(most >= MERGE_AT, bar)) continue;
          if (wg_any(most >= SV, bar)) {
            // a row overflowed: drop the tile's keys and offer it again in
            // eight rounds of 16 columns a row (CW keys at most), merging
            // the rows past SV - CW between rounds
            if (lead) {
              rs.cnt[ra] = ca;
              rs.cnt[rb] = cb;
            }
            wg_sync(bar);
#pragma unroll
            for (int round = 0; round < 8; ++round) {
              int top = -1;
#pragma unroll
              for (int i = 8 * round; i < 8 * round + 8; ++i) {
                top = max(top, offer<SV>(rs, (i & 2) ? rb : ra,
                                         (i & 2) ? tb : ta, acc[i],
                                         col0 + (i >> 2) * 8 + (i & 1),
                                         c_end, first, ids));
              }
              if (wg_any(top >= SV - CW, bar)) {
                merge_wg<SV>(rs, L0, x.row0, W, SV - CW, r0, w4, lane,
                             scratch);
                wg_sync(bar);
                ta = load_thr(rs, ra, live_a);
                tb = load_thr(rs, rb, live_b);
              }
            }
          }
          merge_wg<SV>(rs, L0, x.row0, W, MERGE_AT, r0, w4, lane, scratch);
          wg_sync(bar);
          ta = load_thr(rs, ra, live_a);
          tb = load_thr(rs, rb, live_b);
        }
      }
      if (resident) ++qj;
    }
    if constexpr (LS) {
      close_ls_rows(R, x, m, W, L0, r0w, lane);
    } else {
      wg_sync(bar);
      merge_wg<SV>(rs, L0, x.row0, W, 0, r0, w4, lane, scratch);
      pad_rows(rs, L0, x.row0, m, W, r0 + w4, r0 + 64, 4, lane);
      wg_sync(bar);
    }
  }
  if constexpr (LS) stop_mergers(R, CWARPS, MERGERS, lane);
}

// ---------------------------------------------------------------- fp32 --

namespace ff {

constexpr int CWARPS = 8;         // consumer warps, 16 query rows each
constexpr int MERGERS = 3;        // merge warps (lists in shared memory)
constexpr int THREADS = (CWARPS + 1 + MERGERS) * 32;  // + the producer
constexpr int ROW = 128;          // bytes of a chunk row: 32 f32, 64 bf16
constexpr int CHUNK = BN * ROW;   // a chunk of 128 rows, 16 KB
constexpr int STAGE = 2 * CHUNK;  // the candidate chunk, then the query's
constexpr int SV = 32;            // survivor slots a row (device lists)
constexpr int MERGE_AT = SV / 2;
constexpr int CW = 16;            // keys a row gains in a round at most
// shared memory past the stages, lists in device memory: the survivors,
// the merging warps' scratch, row states, mbarriers
constexpr int GLOBAL_BYTES = BM * SV * 8 + CWARPS * LCAP * 8 + BM * 16 +
                             (2 * tc::MAX_STAGES + 2) * 8;
constexpr int HELD = BM * 4;      // a row's count at a tile's start
static_assert(BM == 16 * CWARPS, "a consumer warp's 16 rows");

// Four consecutive values of a chunk row in shared memory, as float32 (a
// bfloat16 is the high half of its float32).
__device__ __forceinline__ float4 ld4(const unsigned char* p, float) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const unsigned char* p, uint16_t) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}

// Row i's eight scores (acc[i * 8 ..]) for a runtime i, by selects: the
// filter then runs as a loop over the rows, one copy of its code, instead
// of eight unrolled ones whose temporaries crowd the accumulators.
__device__ __forceinline__ void row_scores(const float (&acc)[64], int i,
                                           float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float x = acc[j];
#pragma unroll
    for (int k = 1; k < 8; ++k) x = i == k ? acc[k * 8 + j] : x;
    v[j] = x;
  }
}

}  // namespace ff

// T: the rows' type, float or bf16 bits (uint16_t). LS: the rows' lists in
// shared memory with the merge warps (W <= 64); else in device memory, SV
// survivor slots a row, each consumer warp merging its own rows.
template <typename T, bool LS>
__global__ void __launch_bounds__(ff::THREADS, 1)
    knn_merge_ffma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tcand, int64_t m,
                   int64_t n, int kt_n, int64_t first,
                   const int64_t* __restrict__ ids, const int64_t* run,
                   int64_t w, int W, int64_t* out, int64_t* parts,
                   int units, int stages, int wl) {
  using namespace ff;
  constexpr int STEPS = ROW / (4 * static_cast<int>(sizeof(T)));
  constexpr int VALS = ROW / static_cast<int>(sizeof(T));
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((tc::ALIGN - (smem_u32(smem_raw) & (tc::ALIGN - 1))) &
                  (tc::ALIGN - 1));
  unsigned char* tail = base + stages * STAGE;
  Rows rs = {};
  tc::Ls R = {};
  uint64_t* full;
  if constexpr (LS) {
    R.sv = reinterpret_cast<int64_t*>(tail);
    R.lists = R.sv + BM * 2 * tc::SVH;
    R.thr = R.lists + BM * wl;
    R.len = reinterpret_cast<int32_t*>(R.thr + BM);
    R.cnt = R.len + BM;
    R.act = R.cnt + 2 * BM;
    R.busy = R.act + BM;
    R.queue = R.busy + 2 * BM;
    R.ctl = R.queue + tc::QCAP;
    R.wl = wl;
    full = reinterpret_cast<uint64_t*>(R.ctl + 4);
  } else {
    rs.sv = reinterpret_cast<int64_t*>(tail);
    rs.scratch = rs.sv + BM * SV;
    rs.thr_hi = reinterpret_cast<int32_t*>(rs.scratch + CWARPS * LCAP);
    rs.thr_lo = reinterpret_cast<uint32_t*>(rs.thr_hi + BM);
    rs.cnt = reinterpret_cast<int32_t*>(rs.thr_lo + BM);
    rs.len = rs.cnt + BM;
    full = reinterpret_cast<uint64_t*>(rs.len + BM);
  }
  uint64_t* empty = full + stages;
  int32_t* held = reinterpret_cast<int32_t*>(empty + stages);  // [BM]

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(full + s, 1);
      tc::mbar_init(empty + s, CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (LS) {
    for (int i = threadIdx.x; i < tc::QCAP + 4; i += THREADS) R.queue[i] = 0;
  }
  __syncthreads();

  const int64_t blocks = (m + BM - 1) / BM, tiles = (n + BN - 1) / BN;
  const int64_t total = blocks * units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;

  if (warp == CWARPS) {
    // the producer: each step's candidate chunk and query chunk
    if (lane != 0) return;
    for (int64_t u = blockIdx.x; u < total; u += gridDim.x) {
      const Unit x = unit_at(u, blocks, tiles, units);
      for (int64_t t = x.t_lo; t < x.t_hi; ++t) {
        for (int kc = 0; kc < kt_n; ++kc) {
          tc::mbar_wait(empty + stage, phase ^ 1);
          tc::mbar_expect_tx(full + stage, STAGE);
          unsigned char* sp = base + stage * STAGE;
          tc::tma_load(sp, &tcand, kc * VALS, static_cast<int>(t * BN),
                       full + stage);
          tc::tma_load(sp + CHUNK, &tq, kc * VALS, static_cast<int>(x.row0),
                       full + stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    // stay until the consumers have released every stage (every load done)
    for (int s = 0; s < stages; ++s) {
      tc::mbar_wait(empty + stage, phase ^ 1);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  if (warp > CWARPS) {
    if constexpr (LS) tc::merge_loop(R, W, lane);
    return;
  }

  // the consumers: warp `warp` owns block rows r0w .. r0w + 15; this
  // thread holds the scores of rows ra + 2 i (i < 8) and candidate
  // columns tx + 16 j (j < 8) of a tile, acc[i * 8 + j]
  const int r0w = warp * 16, ty = lane >> 4, tx = lane & 15;
  const int ra = r0w + ty, t7 = tx & 7;
  int64_t* scratch = LS ? nullptr : rs.scratch + warp * LCAP;
  for (int64_t u = blockIdx.x; u < total; u += gridDim.x) {
    const Unit x = unit_at(u, blocks, tiles, units);
    int64_t* L0 = units == 1 ? out : parts + x.split * m * W;
    if constexpr (LS) {
      tc::open_ls_rows(R, x, m, run, w, W, r0w, lane);
    } else {
      open_rows(rs, x, m, run, w, W, L0 + x.row0 * W, W, L0 != run, r0w,
                r0w + 16, lane, 32);
      __syncwarp();
    }
    const int64_t c_end = min(x.t_hi * BN, n);
    for (int64_t t = x.t_lo; t < x.t_hi; ++t) {
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
      for (int kc = 0; kc < kt_n; ++kc) {
        tc::mbar_wait(full + stage, phase);
        // the stage's chunk rows in the 128-byte swizzle: 16-byte piece p
        // of row r at p ^ (r & 7). Query row ra + 2 i has r & 7 = ty ^ 2i,
        // so its piece P sits at base qa[(P ^ 2i) & 1] plus the piece's
        // even part; candidate row tx + 16 j has r & 7 = t7.
        const unsigned char* sp = base + stage * STAGE;
        const unsigned char* qa0 = sp + CHUNK + ra * ROW + (ty << 4);
        const unsigned char* qa1 = qa0 + 16 - 32 * ty;
        const unsigned char* cb = sp + tx * ROW;
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          // depth values 4 s .. 4 s + 3 of the chunk: piece P, byte off
          const int P = (4 * s * static_cast<int>(sizeof(T))) >> 4;
          const int off = (4 * s * static_cast<int>(sizeof(T))) & 15;
          float4 a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int K = P ^ ((2 * i) & 7);
            a[i] = ld4((K & 1 ? qa1 : qa0) + 2 * ROW * i + ((K & ~1) << 4) +
                           off,
                       T());
          }
          const unsigned char* pb = cb + ((P ^ t7) << 4) + off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 b = ld4(pb + 16 * ROW * j, T());
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float& v = acc[i * 8 + j];
              v = fmaf(a[i].x, b.x, v);
              v = fmaf(a[i].y, b.y, v);
              v = fmaf(a[i].z, b.z, v);
              v = fmaf(a[i].w, b.w, v);
            }
          }
        }
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(empty + stage);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // the tile's keys: each of the thread's rows tested once at its
      // largest score against its threshold, its keys offered only where
      // that passes; the rows' counts the tile starts from kept in `held`
      // (by the tx = 0 lanes), to drop its keys again where it overflows
      const int64_t col0 = t * BN + tx;
      int most = -1;
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ra + 2 * i;
          held[r] = LS ? R.cnt[2 * r + R.act[r]] : rs.cnt[r];
        }
      }
      __syncwarp();
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        const int r = ra + 2 * i;
        float v[8];
        row_scores(acc, i, v);
        float top = v[0];
#pragma unroll
        for (int j = 1; j < 8; ++j) top = tc::max_nan(top, v[j]);
        const tc::Thr th =
            LS ? tc::thr_of(tc::ld_volatile(&R.thr[r]), x.row0 + r < m)
               : tc::load_thr(rs, r, x.row0 + r < m);
        if (__builtin_expect(!(top < th.f), 0)) {
          const int h = LS ? R.act[r] : 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            most = max(most, LS ? tc::offer_ls(R, r, h, th, v[j],
                                               col0 + 16 * j, c_end, first,
                                               ids)
                                : tc::offer<SV>(rs, r, th, v[j],
                                                col0 + 16 * j, c_end, first,
                                                ids));
          }
        }
      }
      if constexpr (LS) {
        if (!__any_sync(0xffffffffu, most >= 0)) continue;
        if (__any_sync(0xffffffffu, most >= tc::SVH)) {
          // a half overflowed: drop the tile's keys and offer the tile in
          // eight rounds of one column a thread (16 keys a row at most),
          // each after the halves past SVH - CW are handed over
          if (tx == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int r = ra + 2 * i;
              R.cnt[2 * r + R.act[r]] = held[r];
            }
          }
#pragma unroll 1
          for (int j = 0; j < 8; ++j) {
            tc::make_room(R, r0w, lane, W, tc::SVH - CW);
#pragma unroll 1
            for (int i = 0; i < 8; ++i) {
              const int r = ra + 2 * i;
              float v[8];
              row_scores(acc, i, v);
              float x_ij = v[0];
#pragma unroll
              for (int k = 1; k < 8; ++k) x_ij = j == k ? v[k] : x_ij;
              tc::offer_ls(R, r, R.act[r],
                           tc::thr_of(tc::ld_volatile(&R.thr[r]),
                                      x.row0 + r < m),
                           x_ij, col0 + 16 * j, c_end, first, ids);
            }
          }
        }
        // hand the halves past SVH / 2 to the merge warps where the row's
        // other half is free
        __threadfence_block();
        __syncwarp();
        tc::hand_over_rows(R, r0w, lane, tc::SVH / 2);
        __syncwarp();
      } else {
        if (!__any_sync(0xffffffffu, most >= MERGE_AT)) continue;
        if (__any_sync(0xffffffffu, most >= SV)) {
          // a row overflowed: drop the tile's keys and offer it again in
          // eight rounds of one column a thread, merging the rows past SV
          // - CW between rounds
          if (tx == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) rs.cnt[ra + 2 * i] = held[ra + 2 * i];
          }
          __syncwarp();
#pragma unroll 1
          for (int j = 0; j < 8; ++j) {
            int top = -1;
#pragma unroll 1
            for (int i = 0; i < 8; ++i) {
              const int r = ra + 2 * i;
              float v[8];
              row_scores(acc, i, v);
              float x_ij = v[0];
#pragma unroll
              for (int k = 1; k < 8; ++k) x_ij = j == k ? v[k] : x_ij;
              top = max(top, tc::offer<SV>(
                                 rs, r, tc::load_thr(rs, r, x.row0 + r < m),
                                 x_ij, col0 + 16 * j, c_end, first, ids));
            }
            if (__any_sync(0xffffffffu, top >= SV - CW)) {
              merge_rows<SV>(rs, L0, x.row0, W, SV - CW, r0w, r0w + 16, 1,
                             lane, scratch);
            }
          }
        }
        __syncwarp();
        merge_rows<SV>(rs, L0, x.row0, W, MERGE_AT, r0w, r0w + 16, 1, lane,
                       scratch);
      }
    }
    if constexpr (LS) {
      tc::close_ls_rows(R, x, m, W, L0, r0w, lane);
    } else {
      __syncwarp();
      merge_rows<SV>(rs, L0, x.row0, W, 0, r0w, r0w + 16, 1, lane, scratch);
      pad_rows(rs, L0, x.row0, m, W, r0w, r0w + 16, 1, lane);
      __syncwarp();
    }
  }
  if constexpr (LS) tc::stop_mergers(R, CWARPS, MERGERS, lane);
}

// ------------------------------------------------------------- combine --

// K4's second kernel where the candidates are split (units > 1): each
// row's top W of its units' lists (parts (units, m, W), each sorted
// descending and padded with EMPTY_KEY), a warp a row and a lane a list:
// W rounds of a warp-wide maximum of the lists' heads (the lowest lane
// among equals), the winner's lane stepping on (its next key already
// loaded).
__global__ void __launch_bounds__(256)
    knn_merge_combine(const int64_t* __restrict__ parts, int units,
                      int64_t m, int W, int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= m) return;
  const bool mine = lane < units;
  const int64_t* L = parts + (static_cast<int64_t>(lane) * m + row) * W;
  int pos = 0;
  int64_t head = mine ? L[0] : EMPTY_KEY;
  int64_t next = mine && W > 1 ? L[1] : EMPTY_KEY;
  for (int i = 0; i < W; ++i) {
    int64_t best = head;
    int who = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t b = __shfl_xor_sync(0xffffffffu, best, o);
      const int v = __shfl_xor_sync(0xffffffffu, who, o);
      if (b > best || (b == best && v < who)) {
        best = b;
        who = v;
      }
    }
    if (lane == 0) out[row * W + i] = best;
    if (lane == who) {
      ++pos;
      head = next;
      next = mine && pos + 1 < W ? L[pos + 1] : EMPTY_KEY;
    }
  }
}

// ---------------------------------------------------------------- host --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of (rows, d) bfloat16 (f32 false) or float32 rows: boxes
// of 128 rows x 128 bytes (64 or 32 values) in the 128-byte swizzle, zeros
// past the edges.
cudaError_t tile_map(CUtensorMap* map, EncodeTiled fn, const void* rows,
                     int64_t n_rows, int64_t d, bool f32 = false) {
  const cuuint64_t size = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * size};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / size), BN};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(rows), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool LS>
cudaError_t start_wgmma(const CUtensorMap& tq, const CUtensorMap& tcand,
                        int64_t m, int64_t n, int kt_n, int64_t first,
                        const int64_t* ids, const int64_t* run, int64_t w,
                        int W, int64_t* out, int64_t* parts, int units,
                        int grid, int stages, bool resident, int wl,
                        cudaStream_t st) {
  auto kernel = knn_merge_wgmma<LS>;
  const int smem = tc::ALIGN + (LS ? tc::ls_bytes(wl) : tc::GLOBAL_BYTES) +
                   stages * (resident ? tc::CHUNK : 2 * tc::CHUNK) +
                   (resident ? kt_n * tc::CHUNK : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, tc::THREADS, smem, st>>>(tq, tcand, m, n, kt_n, first, ids,
                                          run, w, W, out, parts, units,
                                          stages, resident ? 1 : 0, wl);
  return cudaGetLastError();
}

// The stages a bf16 launch gets in `limit` bytes past the fixed part, and
// whether the query tile stays resident: it does where that leaves
// MIN_STAGES stages of candidates, else each stage carries a query chunk.
int wgmma_stages(int limit, int fixed, int kt_n, bool* resident) {
  const int room = limit - tc::ALIGN - fixed;
  int stages = (room - kt_n * tc::CHUNK) / tc::CHUNK;
  *resident = stages >= tc::MIN_STAGES;
  if (!*resident) stages = room / (2 * tc::CHUNK);
  return stages < tc::MAX_STAGES ? stages : tc::MAX_STAGES;
}

cudaError_t launch_wgmma(const void* q, int64_t m, const void* c, int64_t n,
                         int64_t d, int64_t first, const int64_t* ids,
                         const int64_t* run, int64_t w, int W, int64_t* out,
                         int64_t* parts, int units, int grid, int limit,
                         cudaStream_t st) {
  EncodeTiled fn;
  cudaError_t err = encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tcand;
  err = tile_map(&tq, fn, q, m, d);
  if (err == cudaSuccess) {
    // no candidates: a map of the query rows, never read
    err = n > 0 ? tile_map(&tcand, fn, c, n, d)
                : tile_map(&tcand, fn, q, m, d);
  }
  if (err != cudaSuccess) return err;
  const int kt_n = static_cast<int>((d + tc::KC - 1) / tc::KC);
  // lists of at most 64 keys stay in shared memory, with the merge warps,
  // where that leaves MIN_STAGES stages; else they are in device memory
  const int wl = (W + 7) / 8 * 8;
  bool resident;
  int stages = wgmma_stages(limit, tc::ls_bytes(wl), kt_n, &resident);
#ifndef K4_GLOBAL_LISTS
  if (W <= tc::WL_MAX && stages >= tc::MIN_STAGES) {
    return start_wgmma<true>(tq, tcand, m, n, kt_n, first, ids, run, w, W,
                             out, parts, units, grid, stages, resident, wl,
                             st);
  }
#endif
  stages = wgmma_stages(limit, tc::GLOBAL_BYTES, kt_n, &resident);
  if (stages < 2) return cudaErrorInvalidValue;
  return start_wgmma<false>(tq, tcand, m, n, kt_n, first, ids, run, w, W,
                            out, parts, units, grid, stages, resident, 0,
                            st);
}

template <typename T, bool LS>
cudaError_t start_ffma(const CUtensorMap& tq, const CUtensorMap& tcand,
                       int64_t m, int64_t n, int kt_n, int64_t first,
                       const int64_t* ids, const int64_t* run, int64_t w,
                       int W, int64_t* out, int64_t* parts, int units,
                       int grid, int stages, int wl, cudaStream_t st) {
  auto kernel = knn_merge_ffma<T, LS>;
  const int smem = tc::ALIGN + (LS ? tc::ls_bytes(wl) : ff::GLOBAL_BYTES) +
                   ff::HELD + stages * ff::STAGE;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ff::THREADS, smem, st>>>(tq, tcand, m, n, kt_n, first, ids,
                                          run, w, W, out, parts, units,
                                          stages, wl);
  return cudaGetLastError();
}

// The fp32 form: T float or bf16 bits, read by TMA in chunks of 128 bytes
// a row; lists in shared memory (W <= 64) where that leaves MIN_STAGES
// stages, else in device memory.
template <typename T>
cudaError_t launch_ffma(const void* q, int64_t m, const void* c, int64_t n,
                        int64_t d, int64_t first, const int64_t* ids,
                        const int64_t* run, int64_t w, int W, int64_t* out,
                        int64_t* parts, int units, int grid, int limit,
                        cudaStream_t st) {
  constexpr bool f32 = sizeof(T) == 4;
  EncodeTiled fn;
  cudaError_t err = encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tcand;
  err = tile_map(&tq, fn, q, m, d, f32);
  if (err == cudaSuccess) {
    // no candidates: a map of the query rows, never read
    err = n > 0 ? tile_map(&tcand, fn, c, n, d, f32)
                : tile_map(&tcand, fn, q, m, d, f32);
  }
  if (err != cudaSuccess) return err;
  const int vals = ff::ROW / static_cast<int>(sizeof(T));
  const int kt_n = static_cast<int>((d + vals - 1) / vals);
  const int wl = (W + 7) / 8 * 8;
  const int room = limit - tc::ALIGN - ff::HELD;
  int stages = (room - tc::ls_bytes(wl)) / ff::STAGE;
  if (stages > tc::MAX_STAGES) stages = tc::MAX_STAGES;
  if (W <= tc::WL_MAX && stages >= tc::MIN_STAGES) {
    return start_ffma<T, true>(tq, tcand, m, n, kt_n, first, ids, run, w, W,
                               out, parts, units, grid, stages, wl, st);
  }
  stages = (room - ff::GLOBAL_BYTES) / ff::STAGE;
  if (stages > tc::MAX_STAGES) stages = tc::MAX_STAGES;
  if (stages < 2) return cudaErrorInvalidValue;
  return start_ffma<T, false>(tq, tcand, m, n, kt_n, first, ids, run, w, W,
                              out, parts, units, grid, stages, 0, st);
}

}  // namespace

// The merge of knn/topk.py merge_block: q (m, d) and c (n, d) row-major;
// the candidates' indices are first + j, or ids[j] where ids is not null;
// run (m, w) int64 keys sorted descending, or w = 0; out (m, W) int64, W =
// min(k, w + n) >= w, may be run itself. Both forms read the rows by TMA:
// each row's bytes a multiple of 16 and both bases 16-byte aligned (vec =
// 1). fp32 = 0 multiplies in bf16 on the tensor cores (knn_merge_wgmma):
// the rows must be bfloat16 (is_bf16 = 1). fp32 = 1 multiplies in float32
// on the FFMA pipe (knn_merge_ffma), rows float32 (is_bf16 = 0, d a
// multiple of 4) or bfloat16 (d a multiple of 8). units: the splits of each
// query block's candidates, 1 <= units <= min(32, max(1, ceil(n / 128)));
// with units > 1, parts is scratch of (units, m, W) int64 and a second
// kernel (knn_merge_combine) writes out. The persistent grid takes
// min(ceil(m / 128) * units, SMs) blocks; the shared-memory opt-in and
// the SM count are read on the current device.
extern "C" int fk_knn_merge(const void* q, int64_t m, const void* c,
                            int64_t n, int64_t d, int is_bf16, int fp32,
                            int64_t first, const int64_t* ids,
                            const int64_t* run, int64_t w, int64_t W,
                            int64_t* out, int vec, int64_t units,
                            int64_t* parts, void* stream) {
  if (m <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles = (n + BN - 1) / BN;
  if (W > INT32_MAX || w > W || n < 0 || d <= 0 || units < 1 ||
      units > MAX_UNITS || units > (tiles > 1 ? tiles : 1) ||
      (units > 1 && parts == nullptr) || !vec ||
      d % (is_bf16 ? 8 : 4) != 0 || (!fp32 && !is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t work = (m + BM - 1) / BM * units;
  const int grid = static_cast<int>(work < sms ? work : sms);
  const int U = static_cast<int>(units);
  if (fp32) {
    err = is_bf16 ? launch_ffma<uint16_t>(q, m, c, n, d, first, ids, run, w,
                                          static_cast<int>(W), out, parts,
                                          U, grid, limit, st)
                  : launch_ffma<float>(q, m, c, n, d, first, ids, run, w,
                                       static_cast<int>(W), out, parts, U,
                                       grid, limit, st);
  } else {
    err = launch_wgmma(q, m, c, n, d, first, ids, run, w,
                       static_cast<int>(W), out, parts, U, grid, limit, st);
  }
  if (err != cudaSuccess || U == 1) return static_cast<int>(err);
  knn_merge_combine<<<static_cast<unsigned>((m + 7) / 8), 256, 0, st>>>(
      parts, U, m, static_cast<int>(W), out);
  return static_cast<int>(cudaGetLastError());
}
