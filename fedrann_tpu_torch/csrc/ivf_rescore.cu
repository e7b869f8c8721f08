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
// cluster's true counts with masked tails, read from K11's buckets (no
// table, no width).
//
// Bound on the card: operations, 2 * d * the real pair-scores (the sum
// over probed clusters of queries times members): at bf16 over the
// tensor cores' 989 TFLOP/s, at fp32 over the FFMA pipe's 67 TFLOP/s. The
// bytes are the query and member rows each unit gathers and the buffer.
//
// Units. K11 (csrc/ivf_segment_sum.cu, the probe side of knn/ivf.py
// bucket_clusters) cuts the probed clusters into units of BM = 128 query
// slots on the card: (first member offset into the member buckets, first
// query offset into the probe buckets, slots, members), the clusters of
// the longest member counts first, and writes their count to device
// memory; the host launches a grid of the most units there can be
// (ceil(nq p / 128) + C) and a block past the count returns at once. A
// block a unit, one an SM.
// Eight warps; warp w owns the unit's query slots 16 w .. 16 w + 15 in the
// product's result and in everything after it, so no step past the
// product waits for another warp.
//
// The product. The unit's members are walked in tiles of BN = 128, each
// tile's depth in stages of 128 bytes a row, three in flight (cp.async
// groups, one barrier a step): the stage's query rows gathered by the
// unit's probe bucket, its member rows by the cluster's member bucket,
// each row in eight 16-byte cp.async pieces. The rows' pitch d is a
// multiple of 16 bytes from a 16-byte aligned base (rescore_clusters pads
// a width that is not with zero columns, the zeros a stage holds past the
// width anyway), so every piece is one cp.async: a piece past the unit's
// slots, past its members, for a member >= n_real or past d reads no
// source byte (source size 0) and lands as 16 zero bytes, by the same
// instruction. So no thread waits on its gathers before the step's
// wgmma: step + 2's copies overlap this step's product, and across a tile
// boundary the next tile's first copies overlap the offers and merges.
// Piece p of stage row r lies at piece p ^ (r & 7) of the row (the
// 128-byte swizzle), from a 1024-byte aligned stage.
//   - bf16: each warpgroup's 64 query rows times the tile's 128 member
//     rows by wgmma.mma_async m64n128k16 (bf16 in, float32 sums), both
//     operands K-major in shared memory through 128-byte swizzle
//     descriptors. TMA's tiled loads cannot gather rows by index, so the
//     threads gather them by cp.async; each thread's fence.proxy.async
//     after its copies land, then the step's barrier, hands the stage to
//     the tensor cores' (async) proxy.
//   - fp32: a thread 2 x 8 of its warp's rows (ra + 2 i) times 8 members
//     (tx + 16 j), 16-byte loads of four depth values of each (the swizzle
//     spreads them over the banks, as in knn_merge.cu's knn_merge_ffma),
//     fmaf over the depth in order.
// Every pair's score is one fixed sequence of operations whatever its
// place (d never split, sums from +0.0, zero-padded to the stage depth),
// so a row's score against a query is the same bits in every cluster that
// holds it, and the spill copies K7 removes are exact copies.
//
// The selection (what PR 16's running top-k became). A unit sees all of
// its cluster's members, and there are few (~520 at 11b), so each row's
// top W is selected once over the first MR = 256 members, not merged into
// a running list tile by tile:
//   1. The first two tiles' scores go to shared memory (S: 128 rows x 256
//      float32, columns XOR-swizzled by the row). Then each warp selects
//      for its rows, four at a time, G = 8 lanes a row (so four rows'
//      dependent steps overlap): a lane builds the keys of columns j + 8 i
//      (32 in registers; none past the members or for a member >= n_real)
//      and the group finds a key t with exactly need = min(W, valid
//      members) keys at or above it: a bisection on the keys' high words
//      (the scores' monotone bits), each step counting the keys >= mid (a
//      compare a key, a group sum), until a bound counts exactly need;
//      where the need-th key ties others at a high word T, a bisection on
//      the low words of the keys at T (keys are distinct: a cluster's
//      members are; ~15 steps a row at 11b). The keys >= t are compacted
//      (ballots) into the row's list and sorted there by the group's
//      bitonic sort in registers. A warp's lists overlay only its own S
//      rows, each already read into registers when it is written, so no
//      barrier is needed.
//   2. A cluster past MR members (its later tiles, a member range each)
//      keeps the lists: each later tile's keys above the row's threshold
//      (its list's W-th key; EMPTY_KEY while it is short) are offered on
//      the accumulators to the row's survivor slots in shared memory (the
//      S rows freed by step 1): the lanes holding a row take slots by
//      ballots, counting in registers, and store (the score's monotone
//      bits, the member's place); the member's index, the key's low word,
//      is read when the row merges (a high-word tie with the threshold
//      reads it at once). A row past SV / 2 survivors after a tile merges
//      them into its list (its warp's groups, four rows at a time: the
//      survivors sorted by the bitonic network, then the top 64 of list
//      and survivors -- the larger of list[e] and survivors[63 - e] -- by
//      a bitonic clean); a tile that would overflow a row's slots is
//      offered again in eight rounds of 16 columns, merging rows past SV -
//      16 between rounds. After the last tile the rows merge what is left.
// Two forms: W <= 64 (LS) keeps the lists in shared memory (S's first
// half; 64 survivor slots a row in its second half). W > 64 keeps each
// list in its buffer row (the block's own), a warp a row sorting up to
// 256 keys after the first selection and merging the survivors (128 slots
// a row, all of S) by rank (each key's place from a binary search of the
// other run), so any W works.
// No atomics on results: each (query, slot) is one block's, so two
// launches write the same bytes.
//
// Resources: no static shared memory; dynamic 231,936 bytes (three 32 KB
// stages, S's 128 KB, the rows' query indices, survivor counts and list
// lengths, and 1 KB for the 1024-byte alignment); registers and spills of
// each instance as ptxas -v gives them in the build log (chip_smoke.py's
// phase 12 logs them).
//
// K7 (ivf_merge_kernel, entry fk_ivf_merge) replaces the JAX package's
// `_merge_buffers` / `_dedup_topk` (fedrann_tpu/knn/ivf.py:227, :136) and
// the port's `merge_buffers_plain`: per query row, the p lists of L keys
// -> the best min(K, p L), sorted descending; with dedup (spill > 1)
// every key but the highest of each index dropped first. Each list must
// be sorted descending, as both rescores write it. Bound: bytes (the
// buffer read once, the result written once). A warp a row, through a
// merge network: the row's top T = 32 R keys (T >= 64 and >= K times the
// copies an index can have, min(spill, p), at most 512) in R registers a
// lane; list 0's first T keys, then each further list's first T merged in
// (the top T of two sorted runs: the larger of a[e] and b[T - 1 - e], then
// a bitonic clean), the lists read once, coalesced. Without dedup the
// first K are the result. With dedup, exact copies (a row scored in two
// probed clusters: the same bits) sit next to each other and all but the
// first are dropped; if no index then recurs among the kept keys (a hash
// of their low words in shared memory), each kept key is its index's
// highest, and the first K of them are the result, provided there are K,
// or the T-th merged key is EMPTY_KEY (every key was seen). A row that
// fails either test (an index at two scores, or too few distinct keys in
// the top T) finishes exactly in the same kernel by a p-way merge of its
// lists, one key a step, dropping an index already taken (the keys come
// out in descending order, so an index's first copy is its highest); so
// the result is bitwise merge_buffers_plain's on any sorted lists.

#include <cuda_bf16.h>

#include "common.cuh"
#include "keys_sm90.cuh"

namespace {

// K6

constexpr int BM = 128;           // query slots a unit
constexpr int BN = 128;           // members a tile
constexpr int THREADS = 256;      // eight warps, 16 query slots each
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;         // depth stages in flight
constexpr int ROWB = 128;         // bytes of a stage row: 64 bf16, 32 f32
constexpr int CHUNK = BM * ROWB;  // a stage's 128 rows of one side, 16 KB
constexpr int STAGE = 2 * CHUNK;  // the query chunk, then the member chunk
constexpr int MR = 2 * BN;        // members of the first selection
constexpr int ALIGN = 1024;       // the 128-byte swizzle's atom
constexpr int S_BYTES = BM * MR * 4;
constexpr int SMEM_BYTES = ALIGN + STAGES * STAGE + S_BYTES + 3 * BM * 4;
constexpr int WL = 64;            // list slots a row in shared memory
constexpr int ROW_KEYS = MR * 4 / 8;  // keys in a row's S bytes
constexpr int SV_LS = ROW_KEYS - WL;  // survivor slots beside a list: 64
constexpr int SV_DEV = ROW_KEYS;      // with the list in device memory: 128
constexpr int CW = 16;                // keys a row gains in a round at most
static_assert(BM == 16 * WARPS, "a warp's 16 rows");
static_assert(SV_LS == 64 && SV_DEV == 128, "the merges' register runs");
static_assert(SMEM_BYTES <= 232448, "one block an SM");

// 16 bytes to shared memory, of which the first n (16 or 0) from src and
// the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most STAGES - 2 groups are in flight: this step's landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// This thread's shared-memory writes (its cp.async copies, landed, and its
// stores) made visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The rows of a stage are gathered: stage row r is global row row_of(r),
// or zeros where that is negative.
struct QueryRows {  // the unit's query slots
  const int32_t* row;  // [BM] in shared memory; -1 past the unit's slots
  __device__ int64_t operator()(int r) const { return row[r]; }
};

struct MemberRows {  // members t0 + r of the unit's cluster
  const int32_t* mem;  // the cluster's member bucket
  int64_t t0, nm, n_real;
  __device__ int64_t operator()(int r) const {
    if (t0 + r >= nm) return -1;
    const int64_t i = __ldg(mem + t0 + r);
    return i < n_real ? i : -1;
  }
};

// One chunk of 128 gathered rows at depth k0 (values of T) from rows of
// pitch d (a multiple of 16 bytes): 16-byte piece ch of row r at piece ch
// ^ (r & 7) of the row's 128 bytes, zeros where it has no source.
template <typename T, typename RowOf>
__device__ __forceinline__ void load_chunk(unsigned char* dst, const T* src,
                                           const RowOf& row_of, int64_t d,
                                           int64_t k0) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  for (int q = threadIdx.x; q < BM * 8; q += THREADS) {
    const int r = q >> 3, ch = q & 7;
    unsigned char* s = dst + r * ROWB + ((ch ^ (r & 7)) << 4);
    const int64_t gr = row_of(r), gk = k0 + ch * V;
    const bool live = gr >= 0 && gk < d;
    cp_async16(s, live ? src + gr * d + gk : src, live ? 16u : 0u);
  }
}

// S: row r's score of column c (member t0 + c of the first MR) at float
// r * MR + (c ^ swz(r)). The swizzle puts the float2 stores of the bf16
// form, the stores of the fp32 form and a warp's row reads on distinct
// banks (at most two wavefronts a store).
__device__ __forceinline__ int swz(int r) {
  return 8 * (((r & 1) << 1) | ((r >> 1) & 1));
}

__device__ __forceinline__ int s_at(int r, int c) {
  return r * MR + (c ^ swz(r));
}

// Row r's list (LS: in shared memory, over its warp's first 8 S rows) and
// survivor slots (LS: over the last 8; else all of the row's S bytes).
__device__ __forceinline__ int64_t* ls_list(float* S, int r) {
  return reinterpret_cast<int64_t*>(S) + (r & ~15) * ROW_KEYS +
         (r & 15) * WL;
}

template <bool LS>
__device__ __forceinline__ int64_t* survivors(float* S, int r) {
  int64_t* s = reinterpret_cast<int64_t*>(S);
  return LS ? s + (r & ~15) * ROW_KEYS + 16 * WL + (r & 15) * SV_LS
            : s + r * ROW_KEYS;
}

// What a block knows of its unit.
struct Unit {
  const int32_t* mem;  // the cluster's members (its member bucket)
  const int32_t* qt;   // the unit's query rows (its probe bucket from j0)
  const int32_t* st;   // their probe slots
  int64_t nm, n_real, p;
  int mq, W;
  int64_t* buf;
  float* S;
  int32_t* cnt;  // [BM] survivors since the row's last merge
  int32_t* len;  // [BM] the row's list length
};

// Slot r's buffer row: its W keys.
__device__ __forceinline__ int64_t* out_row(const Unit& u, int r) {
  return u.buf + (static_cast<int64_t>(u.qt[r]) * u.p + u.st[r]) * u.W;
}

template <bool LS>
__device__ __forceinline__ int64_t* list_of(const Unit& u, int r) {
  return LS ? ls_list(u.S, r) : out_row(u, r);
}

// The selection works on G = 8 lanes a row, four rows of a warp at once,
// so four rows' dependent steps (bisection counts, bitonic stages)
// overlap; sums and extremes of a row are shuffles within its group.
constexpr int G = 8;
constexpr int GROUPS = 32 / G;

template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The number of hi[i] >= x over the group (hi[i] = INT32_MIN where no
// key is, and x > INT32_MIN), four running sums against the add chain.
template <int R>
__device__ __forceinline__ int count_ge(const int32_t (&hi)[R], int32_t x) {
  int c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < R; ++i) c[i & 3] += hi[i] >= x;
  return group_sum(c[0] + c[1] + c[2] + c[3]);
}

// A key t with exactly `need` of the group's distinct keys (hi[i], lo[i])
// where bit i of okm is set at or above it, 1 <= need < n, their number
// (hi[i] = INT32_MIN where the bit is clear): a bisection on the high
// words (the scores' monotone bits, int32 compares), stopping at a bound
// that counts exactly need; where it ends between two adjacent high words
// (the need-th key ties others at T), a bisection on the low words of the
// keys at T. Each group of the warp runs its own; the loops run until
// every group is done.
template <int R>
__device__ __forceinline__ int64_t kth_key(const int32_t (&hi)[R],
                                           const uint32_t (&lo)[R],
                                           uint32_t okm, int need) {
  int32_t mn = INT32_MAX, mx = INT32_MIN;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if ((okm >> i) & 1) mn = min(mn, hi[i]);
    mx = max(mx, hi[i]);
  }
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  // more than need keys have a high word >= a, fewer than need >= b; a
  // mid is always above a >= INT32_MIN, so count_ge counts only keys
  int64_t a = mn, b = static_cast<int64_t>(mx) + 1, t = 0;
  bool done = false;
  while (__any_sync(0xffffffffu, !done && b - a > 1)) {
    const bool go = !done && b - a > 1;
    const int32_t mid = static_cast<int32_t>(a + ((b - a) >> 1));
    const int c = count_ge<R>(hi, mid);
    if (go) {
      if (c == need) {
        t = make_key(mid, 0u);
        done = true;
      } else if (c > need) {
        a = mid;
      } else {
        b = mid;
      }
    }
  }
  const int32_t T = static_cast<int32_t>(a);
  int above = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) above += ((okm >> i) & 1) && hi[i] > T;
  above = group_sum(above);
  // more than need keys are above T or at T with a low word >= x, fewer
  // than need with one >= y (low words are distinct: indices are)
  uint64_t x = 0, y = 1ull << 32;
  while (__any_sync(0xffffffffu, !done)) {
    const uint64_t mid = x + ((y - x) >> 1);
    int c = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      c += ((okm >> i) & 1) && hi[i] == T && lo[i] >= mid;
    }
    c = above + group_sum(c);
    if (!done) {
      if (c == need) {
        t = make_key(T, static_cast<uint32_t>(mid));
        done = true;
      } else if (c > need) {
        x = mid;
      } else {
        y = mid;
      }
    }
  }
  return t;
}

// Sort L[0, n) descending in place (n <= 32 R), by one warp.
template <int R>
__device__ __forceinline__ void sort_list(int64_t* L, int n, int lane) {
  int64_t v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = 32 * i + lane;
    v[i] = e < n ? L[e] : EMPTY_KEY;
  }
  sort_desc<R>(v, lane);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (32 * i + lane < n) L[32 * i + lane] = v[i];
  }
  __syncwarp();
}

// Step 1: each of the warp's rows' top min(W, valid members) over the
// first min(nm, MR) members, from S, into its list; group g of the warp
// takes rows r0w + 4 p + g, lane j of it columns j + 8 i.
template <bool LS>
__device__ __forceinline__ void select_first(const Unit& u, int r0w,
                                             int lane) {
  constexpr int R = MR / G;
  const int g = lane / G, j = lane % G;
  uint32_t lo[R];
  uint32_t okm = 0;
  int n = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = G * i + j;
    const int64_t index = c < u.nm ? __ldg(u.mem + c) : u.n_real;
    okm |= static_cast<uint32_t>(index < u.n_real) << i;
    lo[i] = 0xFFFFFFFFu - static_cast<uint32_t>(index);
  }
  n = group_sum(__popc(okm));
  const int need = min(u.W, n);
#pragma unroll 1
  for (int p = 0; p < 16; p += GROUPS) {
    const int r = r0w + p + g;
    const bool live = r < u.mq;
    int32_t hi[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      hi[i] = (okm >> i) & 1 ? mono_bits(u.S[s_at(r, G * i + j)])
                             : INT32_MIN;
    }
    const int64_t t =
        need < n ? kth_key<R>(hi, lo, okm, need) : INT64_MIN;
    // the keys >= t, exactly need of them, into the list (its slots
    // overlay only S rows of this warp already read)
    int64_t* L = list_of<LS>(u, live ? r : r0w);
    __syncwarp();
    int base = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t k = make_key(hi[i], lo[i]);
      const bool sel = ((okm >> i) & 1) && k >= t;
      const uint32_t b = (__ballot_sync(0xffffffffu, sel) >> (G * g)) &
                         ((1u << G) - 1u);
      if (sel && live) L[base + __popc(b & ((1u << j) - 1u))] = k;
      base += __popc(b);
    }
    __syncwarp();
    if constexpr (LS) {
      // the group sorts its row's keys (need <= WL = 8 G)
      int64_t v[WL / G];
#pragma unroll
      for (int i = 0; i < WL / G; ++i) {
        const int e = G * i + j;
        v[i] = live && e < need ? L[e] : EMPTY_KEY;
      }
      sort_desc<WL / G, G>(v, j);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < WL / G; ++i) {
        if (live && G * i + j < need) L[G * i + j] = v[i];
      }
    }
    if (live && j == 0) u.len[r] = need;
  }
  __syncwarp();
  if constexpr (!LS) {
    // the lists in the buffer rows, up to 256 keys: a warp a row
    for (int r = r0w; r < r0w + 16 && r < u.mq; ++r) {
      sort_list<MR / 32>(out_row(u, r), need, lane);
    }
  }
}

// A survivor slot holds make_key(score's monotone bits, the member's
// place in its cluster); its key has the member's index in the low word.
__device__ __forceinline__ int64_t survivor_key(const Unit& u, int64_t s) {
  const uint32_t pos = static_cast<uint32_t>(s);
  return make_key(static_cast<int32_t>(s >> 32),
                  0xFFFFFFFFu - static_cast<uint32_t>(__ldg(u.mem + pos)));
}

// Merge the survivors of row r (or nothing, r < 0) into its list (W <=
// 64, both in shared memory), by the lane's group: the survivors sorted,
// then the top 64 of the list and them, the first W kept.
__device__ __forceinline__ void merge_ls(const Unit& u, int r, int j) {
  constexpr int R = WL / G;
  const bool live = r >= 0;
  const int rr = live ? r : 0;
  int64_t* L = ls_list(u.S, rr);
  const int64_t* sv = survivors<true>(u.S, rr);
  const int s = live ? min(u.cnt[rr], SV_LS) : 0;
  const int n = live ? u.len[rr] : 0;
  int64_t a[R], b[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = G * i + j;
    b[i] = e < s ? survivor_key(u, sv[e]) : EMPTY_KEY;
    a[i] = e < n ? L[e] : EMPTY_KEY;
  }
  sort_desc<R, G>(b, j);
  merge_top<R, G>(a, b, j);
  __syncwarp();
  if (live) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (G * i + j < u.W) L[G * i + j] = a[i];
    }
    if (j == 0) {
      u.len[rr] = min(u.W, n + s);
      u.cnt[rr] = 0;
    }
  }
  __syncwarp();
}

// Merge row r's survivors into its list in its buffer row (any W), by one
// warp: the survivors sorted (in their slots), then every key moved to its
// place in the merged list, each place from a binary search of the other
// run.
__device__ void merge_dev(const Unit& u, int r, int lane) {
  int64_t* L = out_row(u, r);
  int64_t* sv = survivors<false>(u.S, r);
  const int s = min(u.cnt[r], SV_DEV), len = u.len[r];
  int64_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 32 * i + lane;
    v[i] = e < s ? survivor_key(u, sv[e]) : EMPTY_KEY;
  }
  sort_desc<4>(v, lane);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) sv[32 * i + lane] = v[i];
  __syncwarp();
  const int ns = min(s, u.W);
  // each new key's place (read before any write)
  int place[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 32 * i + lane;
    place[i] = e < ns ? e + count_above(L, len, v[i]) : u.W;
  }
  const int i0 = count_above(L, len, sv[0]);  // the first old key to move
  __syncwarp();
  // the old keys i0.. move back by their rank among the new, from the
  // back: a chunk's places are >= its own indices, so no key is written
  // before it has been read
  for (int hi = len; hi > i0; hi -= 32) {
    const int i = hi - 32 + lane;
    int64_t x = 0;
    int p = u.W;
    if (i >= i0) {
      x = L[i];
      p = i + count_above(sv, ns, x);
    }
    __syncwarp();
    if (p < u.W) L[p] = x;
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (place[i] < u.W) L[place[i]] = v[i];
  }
  __syncwarp();
  if (lane == 0) {
    u.len[r] = min(u.W, len + ns);
    u.cnt[r] = 0;
  }
  __syncwarp();
}

// Merge the warp's rows holding more than `above` survivors: with the
// lists in shared memory four at a time, a group each; else a warp each.
template <bool LS>
__device__ __forceinline__ void merge_rows(const Unit& u, int r0w, int above,
                                           int lane) {
  __syncwarp();
  uint32_t due = __ballot_sync(
      0xffffffffu, lane < 16 && r0w + lane < u.mq && u.cnt[r0w + lane] > above);
  while (due != 0) {
    if constexpr (LS) {
      // group g takes the g-th row due
      uint32_t left = due;
      int r = -1;
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
        const int f = __ffs(left) - 1;
        if (k == lane / G && f >= 0) r = r0w + f;
        if (left != 0) left &= left - 1;
      }
      merge_ls(u, r, lane % G);
      due = left;
    } else {
      const int f = __ffs(due) - 1;
      merge_dev(u, r0w + f, lane);
      due &= due - 1;
    }
  }
}

// Row r's threshold: its list's W-th key, EMPTY_KEY while the list is
// short, INT64_MAX (nothing passes) for a slot past the unit's.
template <bool LS>
__device__ __forceinline__ int64_t threshold(const Unit& u, int r) {
  if (r >= u.mq) return INT64_MAX;
  return u.len[r] == u.W ? list_of<LS>(u, r)[u.W - 1] : EMPTY_KEY;
}

// Offer score v of a row (member col of the tile at t0; valid: a member
// below nm and n_real) against the row's threshold t. Its lanes are the
// group of `width` lanes from `first` (the lanes holding the row; each
// calls this for its own element, all together); the keys that pass take
// slots cnt + their rank among the group's, stored below SV as
// (monotone bits, member place): survivor_key makes the key at the merge.
// Returns how many of the group's passed.
template <bool LS>
__device__ __forceinline__ int offer(const Unit& u, int r, int64_t t,
                                     float v, int64_t t0, int col,
                                     bool valid, int cnt, int first,
                                     int width, int lane) {
  const int32_t mono = mono_bits(v);
  const int32_t th = static_cast<int32_t>(t >> 32);
  bool pass = valid && mono >= th;
  if (pass && mono == th) {
    // a tie on the high word: the low word decides (the index, rarely)
    pass = 0xFFFFFFFFu - static_cast<uint32_t>(__ldg(u.mem + t0 + col)) >
           static_cast<uint32_t>(t);
  }
  const uint32_t mine = (__ballot_sync(0xffffffffu, pass) >> first) &
                        (width == 32 ? 0xffffffffu : (1u << width) - 1u);
  const int slot = cnt + __popc(mine & ((1u << (lane - first)) - 1u));
  if (pass && slot < (LS ? SV_LS : SV_DEV)) {
    survivors<LS>(u.S, r)[slot] =
        make_key(mono, static_cast<uint32_t>(t0 + col));
  }
  return __popc(mine);
}

// TC: the tensor-core (bf16) product on bf16 rows, else the FFMA (fp32)
// product on float32 rows. LS: W <= 64, the lists in shared memory.
// units: (first member offset, first query offset, slots, members), the
// first *n_units of them (a block past them returns at once).
template <bool TC, bool LS>
__global__ void __launch_bounds__(THREADS, 1)
    ivf_rescore_kernel(const void* __restrict__ rows_v, int64_t d,
                       const int32_t* __restrict__ member,
                       const int32_t* __restrict__ qvals,
                       const int32_t* __restrict__ qslots,
                       const int4* __restrict__ units,
                       const int32_t* __restrict__ n_units, int64_t first,
                       int64_t n_real, int64_t p, int W, int64_t* buf) {
  if (static_cast<int>(blockIdx.x) >= *n_units) return;
  constexpr int SV = LS ? SV_LS : SV_DEV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  int32_t* qrow = reinterpret_cast<int32_t*>(base + STAGES * STAGE + S_BYTES);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0w = warp * 16;
  const int4 q4 = units[blockIdx.x];
  Unit u;
  u.mem = member + q4.x;
  u.qt = qvals + q4.y;
  u.st = qslots + q4.y;
  u.nm = q4.w;
  u.n_real = n_real;
  u.p = p;
  u.mq = q4.z;
  u.W = W;
  u.buf = buf;
  u.S = reinterpret_cast<float*>(base + STAGES * STAGE);
  u.cnt = qrow + BM;
  u.len = u.cnt + BM;

  for (int r = threadIdx.x; r < BM; r += THREADS) {
    qrow[r] = r < u.mq ? static_cast<int32_t>(first + u.qt[r]) : -1;
    u.cnt[r] = 0;
    u.len[r] = 0;
  }
  __syncthreads();

  constexpr int BK = TC ? 64 : 32;  // depth a stage
  const int64_t kt_n = (d + BK - 1) / BK;
  const int64_t tiles = (u.nm + BN - 1) / BN;
  const int64_t steps = tiles * kt_n;
  const int64_t t_sel = tiles < 2 ? tiles - 1 : 1;  // step 1 follows it

  const QueryRows q_of{qrow};
  auto load = [&](int64_t step, int slot) {
    const int64_t tile = step / kt_n, k0 = (step - tile * kt_n) * BK;
    unsigned char* sp = base + slot * STAGE;
    const MemberRows m_of{u.mem, tile * BN, u.nm, n_real};
    if constexpr (TC) {
      const uint16_t* src = static_cast<const uint16_t*>(rows_v);
      load_chunk(sp, src, q_of, d, k0);
      load_chunk(sp + CHUNK, src, m_of, d, k0);
    } else {
      const float* src = static_cast<const float*>(rows_v);
      load_chunk(sp, src, q_of, d, k0);
      load_chunk(sp + CHUNK, src, m_of, d, k0);
    }
  };

  // this thread's rows: bf16 (wgmma's layout) ra and rb = ra + 8, columns
  // 8 j + 2 (lane % 4) and the next (acc[4 j ..]); fp32 ra + 2 i, columns
  // tx + 16 j (acc[8 i + j])
  const int wg = warp >> 2;
  const int ty = lane >> 4, tx = lane & 15;
  const int ra = TC ? r0w + (lane >> 2) : r0w + ty;
  const int rb = ra + 8;
  auto row_of = [&](int e) {
    return TC ? ((e & 2) ? rb : ra) : ra + 2 * (e >> 3);
  };
  auto col_of = [&](int e) {
    return TC ? 8 * (e >> 2) + 2 * (lane & 3) + (e & 1) : tx + 16 * (e & 7);
  };

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) load(i, i);
    cp_async_commit();
  }
  int b = 0;
  for (int64_t step = 0; step < steps; ++step) {
    cp_async_wait_stage();
    if constexpr (TC) fence_proxy_async();
    // every warp is past the step before, so its stage may be refilled
    __syncthreads();
    const int64_t ahead = step + STAGES - 1;
    if (ahead < steps) load(ahead, b == 0 ? STAGES - 1 : b - 1);
    cp_async_commit();
    const unsigned char* sp = base + b * STAGE;
    b = b == STAGES - 1 ? 0 : b + 1;
    if constexpr (TC) {
      const unsigned char* a = sp + wg * 64 * ROWB;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        wgmma_m64n128k16(acc, desc_sw128(a + 32 * ks),
                         desc_sw128(sp + CHUNK + 32 * ks));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    } else {
      // query row ra + 2 i has r & 7 = ty ^ 2 i, so its piece P sits at
      // base qa[(P ^ 2 i) & 1] plus the piece's even part; member row tx +
      // 16 j has r & 7 = tx & 7
      const unsigned char* qa0 = sp + ra * ROWB + (ty << 4);
      const unsigned char* qa1 = qa0 + 16 - 32 * ty;
      const unsigned char* cb = sp + CHUNK + tx * ROWB;
      const int t7 = tx & 7;
#pragma unroll
      for (int s = 0; s < 8; ++s) {  // depth values 4 s .. 4 s + 3: piece s
        float4 qa[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int K = s ^ ((2 * i) & 7);
          qa[i] = *reinterpret_cast<const float4*>(
              (K & 1 ? qa1 : qa0) + 2 * ROWB * i + ((K & ~1) << 4));
        }
        const unsigned char* pb = cb + ((s ^ t7) << 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 mv = *reinterpret_cast<const float4*>(pb + 16 * ROWB * j);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float& v = acc[i * 8 + j];
            v = fmaf(qa[i].x, mv.x, v);
            v = fmaf(qa[i].y, mv.y, v);
            v = fmaf(qa[i].z, mv.z, v);
            v = fmaf(qa[i].w, mv.w, v);
          }
        }
      }
    }
    if ((step + 1) % kt_n != 0) continue;

    // the tile is scored
    const int64_t t = step / kt_n;
    if (t < 2) {
      // into S, for the first selection
      if constexpr (TC) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = static_cast<int>(t) * BN + 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(u.S + s_at(ra, col)) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(u.S + s_at(rb, col)) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          u.S[s_at(row_of(e), static_cast<int>(t) * BN + col_of(e))] = acc[e];
        }
      }
      __syncwarp();
      if (t == t_sel) select_first<LS>(u, r0w, lane);
    } else {
      // a later member range: offers against the thresholds, a row at a
      // time (h: the thread's row ra, rb or ra + 2 h), the row's lanes
      // (bf16 its quad, fp32 its half-warp) counting its survivors by
      // ballots, in registers until the tile is offered
      constexpr int NR = TC ? 2 : 8;
      const int first = TC ? (lane & ~3) : (lane & 16);
      const int width = TC ? 4 : 16;
      const int64_t t0 = t * BN;
      // which of the tile's 128 members count (below nm and n_real)
      uint32_t valid[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t m = t0 + 32 * k + lane;
        valid[k] = __ballot_sync(0xffffffffu,
                                 m < u.nm && __ldg(u.mem + m) < n_real);
      }
      auto valid_at = [&](int col) {
        const int w = col >> 5;
        const uint32_t x = w == 0 ? valid[0] : w == 1 ? valid[1]
                         : w == 2 ? valid[2] : valid[3];
        return ((x >> (col & 31)) & 1u) != 0;
      };
      __syncwarp();
      int cnt[NR];
      int most = 0;
#pragma unroll
      for (int h = 0; h < NR; ++h) {
        const int r = TC ? (h ? rb : ra) : ra + 2 * h;
        const int64_t th = threshold<LS>(u, r);
        cnt[h] = u.cnt[r];
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          if ((TC ? (e >> 1) & 1 : e >> 3) != h) continue;
          cnt[h] += offer<LS>(u, r, th, acc[e], t0, col_of(e),
                              valid_at(col_of(e)), cnt[h], first, width,
                              lane);
        }
        most = max(most, cnt[h]);
      }
      if (__any_sync(0xffffffffu, most > SV)) {
        // a row overflowed: drop the tile's keys (its count in shared
        // memory is still the tile's start) and offer it again in eight
        // rounds of 16 columns a row (columns 16 ro .. 16 ro + 15: bf16
        // acc[8 ro ..], fp32 acc[.. + ro]), merging the rows past SV - CW
        // before each
#pragma unroll 1
        for (int ro = 0; ro < 8; ++ro) {
          merge_rows<LS>(u, r0w, SV - CW, lane);
#pragma unroll
          for (int h = 0; h < NR; ++h) {
            cnt[h] = u.cnt[TC ? (h ? rb : ra) : ra + 2 * h];
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            // element e = 8 ro + q (bf16) or 8 q + ro (fp32) by selects (ro
            // is no constant here): its row is element q's (8 q's), its
            // column 16 ro past theirs
            float v = 0.0f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              v = ro == k ? acc[TC ? 8 * k + q : 8 * q + k] : v;
            }
            const int e0 = TC ? q : 8 * q;
            const int h = TC ? (q >> 1) & 1 : q;
            const int r = row_of(e0);
            const int col = col_of(e0) + 16 * ro;
            cnt[h] += offer<LS>(u, r, threshold<LS>(u, r), v, t0, col,
                                valid_at(col), cnt[h], first, width, lane);
          }
          __syncwarp();
          if (lane == first) {
#pragma unroll
            for (int h = 0; h < NR; ++h) {
              u.cnt[TC ? (h ? rb : ra) : ra + 2 * h] = cnt[h];
            }
          }
        }
      } else if (lane == first) {
#pragma unroll
        for (int h = 0; h < NR; ++h) {
          u.cnt[TC ? (h ? rb : ra) : ra + 2 * h] = cnt[h];
        }
      }
      merge_rows<LS>(u, r0w, SV / 2, lane);
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  }

  // what is left of the survivors, then the lists out
  merge_rows<LS>(u, r0w, 0, lane);
  for (int r = r0w; r < r0w + 16 && r < u.mq; ++r) {
    int64_t* out = out_row(u, r);
    const int n = u.len[r];
    if constexpr (LS) {
      const int64_t* L = ls_list(u.S, r);
      for (int e = lane; e < W; e += 32) out[e] = e < n ? L[e] : EMPTY_KEY;
    } else {
      for (int e = n + lane; e < W; e += 32) out[e] = EMPTY_KEY;
    }
  }
}

template <bool TC, bool LS>
cudaError_t launch_rescore(const void* rows, int64_t d,
                           const int32_t* member, const int32_t* qvals,
                           const int32_t* qslots, const int4* units,
                           const int32_t* n_units, int64_t grid,
                           int64_t first, int64_t n_real, int64_t p, int W,
                           int64_t* buf, cudaStream_t st) {
  auto kernel = ivf_rescore_kernel<TC, LS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES, st>>>(
      rows, d, member, qvals, qslots, units, n_units, first, n_real, p, W,
      buf);
  return cudaGetLastError();
}

// K7

constexpr int K7_WARPS = 8;   // warps a block, a row each
constexpr int T_MAX = 512;    // keys a lane run of the network holds, at most

// The shared memory of a row's warp: the lists' heads for the exact finish
// and the hash of the kept keys' low words (2 T slots), in 16 bytes.
__host__ __device__ __forceinline__ int64_t warp_bytes(int64_t p, int T) {
  return (p * 4 + 2 * T * 4 + 15) / 16 * 16;
}

// Row `row`'s p-way merge, one key a step (the exact finish): each step the
// warp takes the largest head (the lowest list among equal keys), drops it
// if an index already taken has the same low word (dedup), else appends
// it to the row's result dst; the owner lane advances that list.
__device__ void pop_merge(const int64_t* src, int p, int L, int K,
                          bool dedup, int64_t* dst, int32_t* pos, int lane) {
  for (int l = lane; l < p; l += 32) pos[l] = 0;
  __syncwarp();
  // the largest head of this lane's lists; a lane without a list holds
  // (EMPTY_KEY, p)
  int64_t hk = EMPTY_KEY;
  int hl = p;
  auto rescan = [&]() {
    hk = EMPTY_KEY;
    hl = p;
    for (int l = lane; l < p; l += 32) {
      const int64_t h = pos[l] < L ? src[l * L + pos[l]] : EMPTY_KEY;
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
        hit |= static_cast<uint32_t>(dst[i]) == lo;
      }
      dup = __any_sync(0xffffffffu, hit);
    }
    if (!dup) {
      if (lane == 0) dst[taken] = bk;
      ++taken;
    }
    if ((bl & 31) == lane) {
      ++pos[bl];
      rescan();
    }
    __syncwarp();
  }
  for (int i = taken + lane; i < K; i += 32) dst[i] = EMPTY_KEY;
}

// R: a lane's keys of the network's run (T = 32 R). fast: K <= T (else
// every row finishes exactly).
template <int R>
__global__ void __launch_bounds__(K7_WARPS * 32)
    ivf_merge_kernel(const int64_t* __restrict__ buf, int64_t rows, int p,
                     int L, int K, bool dedup, bool fast,
                     int64_t* __restrict__ out, int64_t per_warp) {
  constexpr int T = 32 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                      + warp;
  if (row >= rows) return;  // no barrier of the block follows
  int32_t* pos = reinterpret_cast<int32_t*>(smem + warp * per_warp);
  uint32_t* tab = reinterpret_cast<uint32_t*>(pos + p);
  const int64_t* src = buf + row * p * L;
  int64_t* dst = out + row * K;

  bool exact = fast;
  if (fast) {
    const int lt = min(L, T);
    int64_t a[R], bb[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = 32 * i + lane;
      a[i] = e < lt ? src[e] : EMPTY_KEY;
    }
    for (int l = 1; l < p; ++l) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int e = 32 * i + lane;
        bb[i] = e < lt ? src[l * L + e] : EMPTY_KEY;
      }
      merge_top<R>(a, bb, lane);
    }
    if (!dedup) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (32 * i + lane < K) dst[32 * i + lane] = a[i];
      }
    } else {
      // exact copies sit together: keep the first of each, and no
      // EMPTY_KEY; each kept key's place by ballots
      bool keep[R];
      int place[R];
      int kept = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        int64_t prev = __shfl_up_sync(0xffffffffu, a[i], 1);
        if (i > 0) {
          const int64_t last = __shfl_sync(0xffffffffu, a[i - 1], 31);
          if (lane == 0) prev = last;
        }
        keep[i] = a[i] != EMPTY_KEY && (32 * i + lane == 0 || a[i] != prev);
        const unsigned bal = __ballot_sync(0xffffffffu, keep[i]);
        place[i] = kept + __popc(bal & ((1u << lane) - 1u));
        kept += __popc(bal);
      }
      // an index twice among the kept keys (at two scores)? the low words
      // into a hash of 2 T slots (0 is no low word of a key)
      const uint32_t mask = 2 * T - 1;
      for (int i = lane; i < 2 * T; i += 32) tab[i] = 0u;
      __syncwarp();
      bool twice = false;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!keep[i]) continue;
        const uint32_t lo = static_cast<uint32_t>(a[i]);
        uint32_t h = (lo * 2654435761u) & mask;
        while (true) {
          const uint32_t old = atomicCAS(&tab[h], 0u, lo);
          if (old == 0u) break;
          if (old == lo) {
            twice = true;
            break;
          }
          h = (h + 1) & mask;
        }
      }
      twice = __any_sync(0xffffffffu, twice);
      const bool more = __shfl_sync(0xffffffffu, a[R - 1], 31) != EMPTY_KEY;
      if (twice || (kept < K && more)) {
        exact = false;
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (keep[i] && place[i] < K) dst[place[i]] = a[i];
        }
        for (int e = kept + lane; e < K; e += 32) dst[e] = EMPTY_KEY;
      }
    }
  }
  if (!exact) pop_merge(src, p, L, K, dedup, dst, pos, lane);
}

template <int R>
cudaError_t launch_merge(const int64_t* buf, int64_t rows, int64_t p,
                         int64_t L, int64_t K, bool dedup, int64_t* out,
                         cudaStream_t st) {
  constexpr int T = 32 * R;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  const int64_t per = warp_bytes(p, T);
  if (per > limit) return cudaErrorInvalidValue;
  int64_t warps = limit / per;
  warps = warps < 1 ? 1 : warps > K7_WARPS ? K7_WARPS : warps;
  const int64_t bytes = warps * per;
  auto kernel = ivf_merge_kernel<R>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (rows + warps - 1) / warps;
  kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(warps * 32),
           static_cast<size_t>(bytes), st>>>(
      buf, rows, static_cast<int>(p), static_cast<int>(L),
      static_cast<int>(K), dedup, K <= T, out, per);
  return cudaGetLastError();
}

}  // namespace

// K6: the rescore of knn/ivf.py rescore_clusters. rows (R, d) row-major,
// bfloat16 (is_bf16 = 1: wgmma) or float32 (FFMA), d * itemsize a
// multiple of 16 and rows 16-byte aligned (else cudaErrorInvalidValue;
// rescore_clusters pads the width with zero columns); member the member
// buckets' ids, qvals and qslots the probe buckets' query rows and probe
// slots (int32, knn/ivf.py bucket_clusters); units (grid, 4) int32 (first
// member offset, first query offset, slots <= 128, members), of which the
// first *n_units (a device int32, at most grid) are K6's work list: a
// unit's members are member[x .. x + w), its query slot j is row first +
// qvals[y + j] at probe slot qslots[y + j]; members >= n_real never win;
// buf (nq, p, W) int64, every (query, slot) list of a unit written whole.
// The block's shared-memory opt-in is set on the current device.
extern "C" int fk_ivf_rescore(const void* rows, int64_t d, int is_bf16,
                              const int32_t* member, const int32_t* qvals,
                              const int32_t* qslots, const int32_t* units,
                              const int32_t* n_units, int64_t grid,
                              int64_t first, int64_t n_real, int64_t p,
                              int64_t W, int64_t* buf, void* stream) {
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || W > INT32_MAX || d <= 0 || p <= 0 || grid > INT32_MAX ||
      d * (is_bf16 ? 2 : 4) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* u = reinterpret_cast<const int4*>(units);
  const int w = static_cast<int>(W);
  cudaError_t err;
  if (is_bf16) {
    err = W <= WL ? launch_rescore<true, true>(rows, d, member, qvals, qslots,
                                              u, n_units, grid, first,
                                              n_real, p, w, buf, st)
                  : launch_rescore<true, false>(rows, d, member, qvals,
                                               qslots, u, n_units, grid,
                                               first, n_real, p, w, buf, st);
  } else {
    err = W <= WL ? launch_rescore<false, true>(rows, d, member, qvals,
                                               qslots, u, n_units, grid,
                                               first, n_real, p, w, buf, st)
                  : launch_rescore<false, false>(rows, d, member, qvals,
                                                qslots, u, n_units, grid,
                                                first, n_real, p, w, buf,
                                                st);
  }
  return static_cast<int>(err);
}

// K7: the merge of knn/ivf.py merge_probe_lists. buf (rows, p, L) int64,
// each (row, slot) list sorted descending; out (rows, K) int64, K <= p L;
// spill > 1 drops every key but the first (highest) of each index, an
// index having at most spill copies in the lists of a rescore's buffer
// (the network's run is sized for that; any other buffer stays exact).
extern "C" int fk_ivf_merge(const int64_t* buf, int64_t rows, int64_t p,
                            int64_t L, int64_t K, int spill, int64_t* out,
                            void* stream) {
  if (rows <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (p <= 0 || L <= 0 || K > p * L || p * L > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool dedup = spill > 1;
  const int64_t copies = dedup ? (spill < p ? spill : p) : 1;
  int T = 64;
  while (T < K * copies && T < T_MAX) T *= 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (T) {
    case 64:
      err = launch_merge<2>(buf, rows, p, L, K, dedup, out, st);
      break;
    case 128:
      err = launch_merge<4>(buf, rows, p, L, K, dedup, out, st);
      break;
    case 256:
      err = launch_merge<8>(buf, rows, p, L, K, dedup, out, st);
      break;
    default:
      err = launch_merge<16>(buf, rows, p, L, K, dedup, out, st);
      break;
  }
  return static_cast<int>(err);
}
