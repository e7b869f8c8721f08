// Kernel C: library membership + sign-packed paired embedding.
//
// Replaces the TPU kernel `merge_embed` (bench/pallas_embed.py:212, its
// pallas_call :277, `_kernel` :86, `build_q_cat` :72, `prepare_library`
// :303) and computes what its production twin computes:
// fedrann_tpu/kmers/membership.py `_read_hits_staged` (:367) followed by
// project/embed.py `embed_hits_paired_signs` (:223), scattered into the
// fwd/rev rows of the (2N, d) embedding matrix as
// pipeline._embed_group_scan does. Codes are int64 for every k <= 31, and
// the projection is the 2-bit sign table times a per-row magnitude
// (srp.build_precompute_signs), not a dense f32 table.
//
// Bound on the card: device memory. The function must read the staged
// rows, the library and the sign rows and magnitudes its hits name, and
// write 2 x d floats per row. The sign table is sparse: at the default
// density 1/sqrt(2L) a paired row of 2d = 1,024 fields holds ~2 nonzeros,
// so the float adds (one per nonzero field of a hit's row) are a few per
// hit and never bound it. At the main path's 2,048 x 1,024 chunk (d = 512,
// L = 161,372) that is ~68 MB, 0.020 ms at 3.35 TB/s. What costs time is
// scattered small reads: a binary search of the library reads ~17 32-byte
// L2 sectors per slot (~0.5 GB per chunk, measured as most of the
// kernel's time), and each hit reads its whole 256-byte sign row (465k
// hits, 119 MB, from a 41 MB table that L2 does not keep whole).
//
// So the lookups go through a prefix table, as the TPU kernel's
// `prepare_library` did, built per launch by a pre-pass (one thread per
// library entry, 4 x pow2(L) bytes written, 1 MB at the main path's L):
// start[p] = the first library entry whose code >> shift is >= p, over
// pow2(L) buckets, so a bucket holds ~0.6 entries and a lookup reads ~2
// sectors. Then one block of 256 threads per staged row, in tiles of
// 1,024 slots (4 consecutive slots a thread):
//   1. lookups: padding and a slot equal to its left neighbour (a repeat of
//      the same (code, strand)) are skipped; the code's bucket gives the
//      library range to search, the 4 searches of a thread in lockstep so
//      their loads are issued together;
//   2. the tile's hits are compacted, in slot order (a block prefix sum),
//      into shared memory as j | swap << 31 (swap = the window was the
//      reverse complement);
//   3. accumulation: the d columns are cut into groups of 16; a thread
//      owns one group of one of P = 256 / groups parts of the hit list
//      (hits p, p + P, ...). For each hit it loads the sign word of its
//      16 left fields (columns of P[j]) and the 16 right fields (P[j+L]),
//      8 hits' loads issued before any is used; a zero word (most of
//      them) costs nothing more. For each nonzero field it adds +-mags[j]
//      to its part's fwd or rev partial sum in shared memory (halves
//      swapped for a reverse-strand hit): the work follows the nonzeros,
//      not 2 x d x hits. (Staging the hits' rows in a 4-deep shared-memory
//      ring with cp.async instead was measured slower: its 32 KB ring
//      leaves 3 blocks an SM, and the lookups need the 4th.)
// After the last tile each column is the sum of its P partial sums in part
// order. Every column's order is fixed (part by part, hits in slot order
// within a part), so two launches give the same bytes; there are no
// atomics. Rows with target -1 (padding reads) are not written. Past
// 16 x 256 columns the groups are taken in chunks, each redoing the row's
// lookups.
//
// The dense form (`fk_membership_embed_dense`) computes what `merge_embed`
// itself computes: the projection is a dense paired table (L+1, 2d) of
// float32 or bfloat16 entries, row j = [P[j] | P[j+L]] (merge_embed's
// q_cat; srp.build_precompute_paired, or an imported projection), summed
// per hit as the plain version's embed_hits_paired does. Every hit reads
// a whole 2d-wide row (4,096 bytes at d = 512 in float32), so the bound is
// the bytes of the rows, each distinct row read once: at the main path's
// chunk (465k hits on 161k library rows of a 661 MB float32 table) that
// is a third of what reading every hit's row from device memory takes.
// Blocks that each take a staged row through its hits at their own pace
// read every hit's row from device memory: the rows sharing a library row
// run at other times, and the table passes the 50 MB L2 many times over.
// So the dense form sweeps:
//   1. dense_hits_kernel, one block per staged row: the prefix table's
//      lookups above (tile_hits), the row's hits in slot order into
//      device memory, and its window bounds: the library is cut into
//      windows of ws rows (16 MB of the table's float32 columns, 32 MB of
//      bfloat16 ones), and a
//      row's hits ascend through them (its slots are sorted by code, as
//      the library is);
//   2. dense_sweep_kernel: a block holds g staged rows' fwd and rev sums
//      in shared memory and walks the windows; at each it stages its rows'
//      hits in the window and every thread adds its PER columns of each
//      hit's table row (both halves, swapped for a reverse-strand window)
//      to the hit's row, UNROLL hits' loads in flight. The grid is
//      resident (cooperative launches, in waves where the rows need more
//      blocks than the card holds), and a block waits before a window
//      until all have passed the window `lag` steps back, so every block
//      reads a window's table rows at about the same time: the first from
//      device memory, the rest from L2.
// Every column's sum takes its row's hits in slot order, one float32 add
// each, with no atomics, so two launches give the same bytes. Rows with
// target -1 are not written. Columns past what a block's shared memory
// holds for one row are taken in chunks, each a sweep of its own.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 4;                 // consecutive slots per thread
constexpr int TILE = THREADS * SLOTS;    // slots per tile
constexpr int UNROLL = 8;                // hits whose loads are in flight

// The prefix table's shift: codes >> shift index n_buckets buckets, the
// largest library code in the last one.
__device__ __forceinline__ int bucket_shift(const int64_t* __restrict__ lib,
                                            int64_t lib_size,
                                            int64_t n_buckets) {
  const int bits = 64 - __clzll(static_cast<long long>(lib[lib_size - 1]));
  const int t = 63 - __clzll(static_cast<long long>(n_buckets));
  return bits > t ? bits - t : 0;
}

// start[p] = the first library entry whose bucket (code >> shift) is >= p,
// for p in [0, n_buckets]: entry i writes the buckets after its left
// neighbour's, up to its own (entry lib_size closes the table).
__global__ void prefix_table_kernel(const int64_t* __restrict__ lib,
                                    int64_t lib_size, int64_t n_buckets,
                                    int32_t* __restrict__ start) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i > lib_size) return;
  const int shift = bucket_shift(lib, lib_size, n_buckets);
  const int64_t hi = i < lib_size ? lib[i] >> shift : n_buckets;
  const int64_t lo = i > 0 ? lib[i - 1] >> shift : -1;
  for (int64_t p = lo + 1; p <= hi; ++p) start[p] = static_cast<int32_t>(i);
}

// The 16 fields of column group g (columns 16g .. 16g + 15 < d) of sign
// row `srow`: *left = fields 16g + i (P[j]), *right = fields d + 16g + i
// (P[j+L]), field i at bits 2i; fields of columns >= d are cleared.
__device__ __forceinline__ void group_words(const uint32_t* __restrict__ srow,
                                            int64_t n_words, int64_t d,
                                            int64_t g, uint32_t* left,
                                            uint32_t* right) {
  const int64_t c = 16 * g;
  const uint32_t keep = d - c >= 16 ? 0xFFFFFFFFu
                                    : (1u << (2 * (d - c))) - 1u;
  *left = __ldg(srow + g) & keep;
  const int64_t f = d + c;  // first right field
  const int64_t a = f >> 4;
  const int sh = static_cast<int>(2 * (f & 15));
  uint32_t r = __ldg(srow + a) >> sh;
  if (sh != 0 && a + 1 < n_words) r |= __ldg(srow + a + 1) << (32 - sh);
  *right = r & keep;
}

// Adds +-m for each nonzero field of `word` to sums[16 * g + field].
__device__ __forceinline__ void add_fields(uint32_t word, float m,
                                           float* sums) {
  while (word != 0u) {
    const int bit = __ffs(word) - 1;
    const int field = bit >> 1;
    const uint32_t code = (word >> (2 * field)) & 3u;
    sums[field] += code == 1u ? m : -m;
    word &= ~(3u << (2 * field));
  }
}

// Steps 1-2 for the tile of slots [t0, t0 + TILE) of staged row `row` (h
// slots): its library hits, in slot order, into hit_list as
// j | swap << 31; returns their count. Every thread of the block calls it;
// it ends with a barrier, after which hit_list is complete. *scan picks
// the scratch array (block_scan's rule for calls in a row).
__device__ __forceinline__ int tile_hits(
    const int64_t* __restrict__ row, int64_t h, int64_t t0, bool aligned,
    const int64_t* __restrict__ lib, int64_t lib_size,
    const int32_t* __restrict__ start, int64_t n_buckets, int shift,
    uint32_t* hit_list, int (*scratch)[33], int* scan) {
  const int lane = threadIdx.x & 31;
  // 1. lookups of this thread's SLOTS consecutive slots
  const int64_t i0 = t0 + SLOTS * threadIdx.x;
  int64_t v[SLOTS];
  if (aligned && i0 + SLOTS <= h) {
    const longlong2* p = reinterpret_cast<const longlong2*>(row + i0);
    const longlong2 x = p[0], y = p[1];
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  } else {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      v[s] = i0 + s < h ? row[i0 + s] : PAD_SLOT;
  }
  int64_t prev = __shfl_up_sync(0xffffffffu, v[SLOTS - 1], 1);
  if (lane == 0 && i0 < h) prev = i0 > 0 ? row[i0 - 1] : PAD_SLOT;
  // Lookups through the prefix table: the code's bucket names the
  // library range [start[p], start[p + 1]) that can hold it (~0.6
  // entries), searched in lockstep for the SLOTS slots so each step's
  // loads are issued together. Padding and repeats are not looked up.
  int64_t code[SLOTS];
  int32_t at[SLOTS], end[SLOTS];
  bool found[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    code[s] = v[s] >> 1;
    const int64_t left = s == 0 ? prev : v[s - 1];
    const bool look = lib_size > 0 && v[s] != PAD_SLOT && v[s] != left &&
                      i0 + s < h;
    const int64_t p = look ? code[s] >> shift : n_buckets;
    at[s] = p < n_buckets ? __ldg(start + p) : 0;
    end[s] = p < n_buckets ? __ldg(start + p + 1) : 0;
    found[s] = false;
  }
  bool busy = true;
  while (busy) {  // lower bound of code in [at, end); found if seen
    busy = false;
    int64_t probe[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      probe[s] = at[s] < end[s]
                     ? __ldg(lib + at[s] + ((end[s] - at[s]) >> 1))
                     : code[s];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (at[s] < end[s]) {
        const int32_t half = (end[s] - at[s]) >> 1;
        if (probe[s] < code[s]) {
          at[s] += half + 1;
        } else {
          found[s] |= probe[s] == code[s];
          end[s] = at[s] + half;
        }
        busy |= at[s] < end[s];
      }
    }
  }
  uint32_t entry[SLOTS];
  int own = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    entry[s] = found[s] ? static_cast<uint32_t>(at[s]) |
                              ((v[s] & 1) ? 0u : 0x80000000u)
                        : 0xFFFFFFFFu;
    own += found[s];
  }
  // 2. order-preserving compaction of the tile's hits
  int count;
  int pos = block_scan(own, scratch[*scan], &count);
  *scan ^= 1;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (entry[s] != 0xFFFFFFFFu) hit_list[pos++] = entry[s];
  __syncthreads();
  return count;
}

__global__ void __launch_bounds__(THREADS, 4)
membership_embed_kernel(const int64_t* __restrict__ staged,
                        int64_t h, const int64_t* __restrict__ lib,
                        int64_t lib_size, const int32_t* __restrict__ start,
                        int64_t n_buckets,
                        const uint32_t* __restrict__ signs, int64_t n_words,
                        const float* __restrict__ mags, int64_t d,
                        const int64_t* __restrict__ targets,
                        float* __restrict__ out,
                        int32_t* __restrict__ n_hits) {
  extern __shared__ float sums[];  // parts x (fwd, rev) x cols
  __shared__ uint32_t hit_list[TILE];
  __shared__ int scratch[2][33];
  const int64_t n_groups = (d + 15) / 16;
  const int shift = lib_size > 0 ? bucket_shift(lib, lib_size, n_buckets) : 0;

  int scan = 0;  // which scratch array the next block_scan takes
  const int64_t r = blockIdx.x;
  const int64_t* row = staged + r * h;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  for (int64_t g0 = 0; g0 < n_groups; g0 += THREADS) {
    const int groups = static_cast<int>(
        n_groups - g0 < THREADS ? n_groups - g0 : THREADS);
    const int parts = THREADS / groups;
    const int cols = 16 * groups;
    const int own_g = threadIdx.x % groups;
    const int part = threadIdx.x / groups;
    for (int i = threadIdx.x; i < parts * 2 * cols; i += blockDim.x)
      sums[i] = 0.f;
    __syncthreads();
    int total = 0;
    for (int64_t t0 = 0; t0 < h; t0 += TILE) {
      const int count = tile_hits(row, h, t0, aligned, lib, lib_size, start,
                                  n_buckets, shift, hit_list, scratch,
                                  &scan);
      total += count;
      // 3. accumulation over this part's hits, UNROLL loads in flight
      if (part < parts) {
        const int64_t g = g0 + own_g;
        float* fwd = sums + (2 * part) * cols + 16 * own_g;
        float* rev = fwd + cols;
        for (int e0 = part; e0 < count; e0 += UNROLL * parts) {
          uint32_t ent[UNROLL], wl[UNROLL], wr[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int e = e0 + u * parts;
            ent[u] = e < count ? hit_list[e] : 0u;
            wl[u] = wr[u] = 0u;
            if (e < count)
              group_words(signs + (ent[u] & 0x7FFFFFFFu) * n_words, n_words,
                          d, g, &wl[u], &wr[u]);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if ((wl[u] | wr[u]) == 0u) continue;
            const float m = __ldg(mags + (ent[u] & 0x7FFFFFFFu));
            const bool swap = ent[u] >> 31;
            add_fields(swap ? wr[u] : wl[u], m, fwd);
            add_fields(swap ? wl[u] : wr[u], m, rev);
          }
        }
      }
      __syncthreads();  // hit_list is refilled by the next tile
    }
    // the parts' partial sums, added in part order
    const int64_t t_fwd = targets[2 * r];
    const int64_t t_rev = targets[2 * r + 1];
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const int64_t col = 16 * g0 + c;
      if (col >= d) continue;
      float f = 0.f, b = 0.f;
      for (int q = 0; q < parts; ++q) {
        f += sums[(2 * q) * cols + c];
        b += sums[(2 * q + 1) * cols + c];
      }
      if (t_fwd >= 0) out[t_fwd * d + col] = f;
      if (t_rev >= 0) out[t_rev * d + col] = b;
    }
    if (g0 == 0 && threadIdx.x == 0) n_hits[r] = total;
    __syncthreads();  // sums are cleared for the next column chunk
  }
}

// ---------------------------------------------------------- dense form --

constexpr int DENSE_COLS = 512;    // columns a sweep chunk: 32 lanes x 16
constexpr int DENSE_WARPS_MAX = 8;  // warps a sweep block (rows x parts)

// Kernel C's dense form, first pass: one block per staged row, its hits in
// slot order into hits[r * h ..] (j | swap << 31, tile_hits' entries) and
// their count into n_hits[r], then the row's window bounds: bnd[r * (nw +
// 1) + w] = the first of its hits whose library row is >= w * ws, bnd[..
// + 0] = 0 and bnd[.. + nw] = the count. Rows are sorted, so the hits'
// library rows ascend and the bounds rise with w.
__global__ void __launch_bounds__(THREADS)
dense_hits_kernel(const int64_t* __restrict__ staged, int64_t h,
                  const int64_t* __restrict__ lib, int64_t lib_size,
                  const int32_t* __restrict__ start, int64_t n_buckets,
                  int64_t ws, int nw, uint32_t* __restrict__ hits,
                  int32_t* __restrict__ bnd, int32_t* __restrict__ n_hits) {
  __shared__ uint32_t hit_list[TILE];
  __shared__ int scratch[2][33];
  const int shift = lib_size > 0 ? bucket_shift(lib, lib_size, n_buckets) : 0;
  int scan = 0;
  const int64_t r = blockIdx.x;
  const int64_t* row = staged + r * h;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  uint32_t* mine = hits + r * h;
  int total = 0;
  for (int64_t t0 = 0; t0 < h; t0 += TILE) {
    const int count = tile_hits(row, h, t0, aligned, lib, lib_size, start,
                                n_buckets, shift, hit_list, scratch, &scan);
    for (int i = threadIdx.x; i < count; i += THREADS)
      mine[total + i] = hit_list[i];
    total += count;
    __syncthreads();  // hit_list is refilled by the next tile
  }
  if (threadIdx.x == 0) n_hits[r] = total;
  int32_t* b = bnd + r * (nw + 1);
  for (int w = threadIdx.x; w <= nw; w += THREADS) {
    int lo = 0, hi = total;
    if (w == nw) lo = total;
    const int64_t lim = w * ws;
    while (lo < hi) {  // the block's own writes, visible after the barrier
      const int mid = (lo + hi) >> 1;
      if (static_cast<int64_t>(mine[mid] & 0x7FFFFFFFu) < lim) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    b[w] = lo;
  }
}

// PER consecutive table entries, as loaded: their bits in 32-bit words (a
// bfloat16 pair a word), one load of PER * sizeof(T) bytes. Kept packed
// until they are added, so a bfloat16 hit's row takes half the registers
// of a float32 one.
template <typename T, int PER>
struct Piece {
  static constexpr int WORDS =
      PER * static_cast<int>(sizeof(T)) >= 4
          ? PER * static_cast<int>(sizeof(T)) / 4 : 1;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (PER * sizeof(T) == 16) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (PER * sizeof(T) == 8) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = x.x; w[1] = x.y;
    } else if constexpr (PER * sizeof(T) == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  // entry i as float32 (a bfloat16 is the high half of its float32)
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float(i & 1 ? w[i / 2] & 0xFFFF0000u : w[i / 2] << 16);
    }
  }
};

// Wait until every block of the grid has finished sweep step s (a block may
// run at most `lag` steps ahead of the slowest). A wait past ~2^36 cycles
// traps: a lost block fails the launch instead of holding the card.
__device__ __forceinline__ void wait_step(const int32_t* done, int64_t s) {
  const long long t0 = clock64();
  while (*reinterpret_cast<const volatile int32_t*>(done + s) <
         static_cast<int32_t>(gridDim.x)) {
    __nanosleep(256);
    if (clock64() - t0 > (1ll << 36)) __trap();
  }
}

// Kernel C's dense form, the sweep: `parts` warps sum one staged row (rows
// row0 + blockIdx.x * rows a block + q, q = warp / parts), part p taking
// the row's hits e with e % parts == p, in slot order, each part's sums in
// registers: a lane holds 16 columns of each half of a DENSE_COLS chunk,
// PER entries a load (pieces lane + 32 x, x < 16 / PER). A warp walks its
// hits 32 entries a load, each entry broadcast to the lanes, UNROLL hits'
// table rows in flight, and adds each hit's two halves (swapped for a
// reverse-strand window) to fwd and rev; at a chunk's end part 0 adds the
// other parts' sums in part order (through shared memory) and writes the
// row. The hits ascend through the library, so the warps of the grid
// sweep it together; where lag < the sweep's steps (chunks x windows), a
// block also waits, at each window's end, until every block has passed
// the window lag steps back (all blocks of a launch are resident: a
// cooperative launch), so every block reads a window's table rows at
// about the same time: the first from device memory, the rest from L2.
// Each column's sum takes a part's hits in slot order, one float32 add
// each, and the parts in part order, so two launches give the same bytes.
// Parts shorten the chain of dependent loads a warp walks where few rows
// leave the card's warps idle (a golden chunk: 296 rows of ~300 hits).
template <typename T, int PER>
__global__ void __launch_bounds__(DENSE_WARPS_MAX * 32, 2)
dense_sweep_kernel(const uint32_t* __restrict__ hits, int64_t h,
                   const int32_t* __restrict__ bnd, int nw, int64_t rows,
                   int64_t row0, int parts, const T* __restrict__ table,
                   int64_t d, const int64_t* __restrict__ targets,
                   float* __restrict__ out, int32_t* done, int lag) {
  constexpr int NP = 16 / PER;  // a lane's pieces of each half
  // hits whose table rows are in flight: one float32 row's pieces, or two
  // bfloat16 rows' (32 registers of loads; more spill at 2 blocks of 256
  // threads an SM, and measured slower)
  constexpr int UNROLL_E = sizeof(T) == 4 ? 1 : 2;
  extern __shared__ float stash[];  // parts 1.. of each row: 32 floats a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = warp / parts, part = warp % parts;
  const int64_t r = row0 + static_cast<int64_t>(blockIdx.x) *
                               ((blockDim.x >> 5) / parts) + q;
  const bool live = r < rows;
  const uint32_t* mine = hits + (live ? r : 0) * h;
  const int32_t* bounds = bnd + (live ? r : 0) * (nw + 1);
  const int64_t chunks = (d + DENSE_COLS - 1) / DENSE_COLS;
  const bool paced = lag < chunks * nw;
  int64_t step = 0;  // sweep steps taken (chunks x windows)
  for (int64_t c0 = 0; c0 < d; c0 += DENSE_COLS) {
    float fwd[NP][PER], rev[NP][PER];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < PER; ++i) fwd[p][i] = rev[p][i] = 0.0f;
    }
    // piece p's first column, and whether it is inside d
    bool in[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) in[p] = c0 + (lane + 32 * p) * PER < d;
    int cur = 0;
    int next = live ? bounds[1] : 0;  // the window's bound, a window ahead
    for (int w = 0; w < nw; ++w, ++step) {
      const int end = max(cur, next);
      if (live && w + 2 <= nw) next = bounds[w + 2];
      // this part's hits of the window: e in [cur, end), e % parts == part
      const int mine0 = cur + (part - cur % parts + parts) % parts;
      for (int e0 = mine0; e0 < end; e0 += 32 * parts) {
        const int n = min(32, (end - e0 + parts - 1) / parts);
        const uint32_t ents = lane < n ? mine[e0 + lane * parts] : 0u;
        for (int u0 = 0; u0 < n; u0 += UNROLL_E) {
          uint32_t ent[UNROLL_E];
          Piece<T, PER> lv[UNROLL_E][NP], rv[UNROLL_E][NP];
#pragma unroll
          for (int u = 0; u < UNROLL_E; ++u) {
            ent[u] = __shfl_sync(0xffffffffu, ents, (u0 + u) & 31);
            const T* row = table +
                           static_cast<int64_t>(ent[u] & 0x7FFFFFFFu) * (2 * d) +
                           c0 + lane * PER;
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              if (u0 + u < n && in[p]) {
                lv[u][p].load(row + 32 * PER * p);
                rv[u][p].load(row + d + 32 * PER * p);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL_E; ++u) {
            if (u0 + u >= n) break;
            const bool swap = ent[u] >> 31;
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              if (!in[p]) continue;
#pragma unroll
              for (int i = 0; i < PER; ++i) {
                const float l = lv[u][p].at(i), r = rv[u][p].at(i);
                fwd[p][i] += swap ? r : l;
                rev[p][i] += swap ? l : r;
              }
            }
          }
        }
      }
      cur = end;
      if (paced) {
        __syncthreads();  // every warp of the block is past the window
        if (threadIdx.x == 0) {
          atomicAdd(done + step, 1);
          if (step + 1 >= lag) wait_step(done, step + 1 - lag);
        }
        __syncthreads();
      }
    }
    if (parts > 1) {
      // parts 1.. hand their sums to part 0, which adds them in part order
      float* own = stash + ((q * (parts - 1) + part - 1) * 32 + lane) * 32;
      if (part > 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            own[p * PER + i] = fwd[p][i];
            own[16 + p * PER + i] = rev[p][i];
          }
        }
      }
      __syncthreads();
      if (part == 0) {
        for (int o = 1; o < parts; ++o) {
          const float* x = stash + ((q * (parts - 1) + o - 1) * 32 + lane) * 32;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
#pragma unroll
            for (int i = 0; i < PER; ++i) {
              fwd[p][i] += x[p * PER + i];
              rev[p][i] += x[16 + p * PER + i];
            }
          }
        }
      }
      __syncthreads();  // the stash is rewritten by the next chunk
    }
    // the sums out: fwd to targets[2 r], rev to targets[2 r + 1] (-1: not
    // written)
    if (live && part == 0) {
      const int64_t t_fwd = targets[2 * r], t_rev = targets[2 * r + 1];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (!in[p]) continue;
        const int64_t col = c0 + (lane + 32 * p) * PER;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          if (t_fwd >= 0) out[t_fwd * d + col + i] = fwd[p][i];
          if (t_rev >= 0) out[t_rev * d + col + i] = rev[p][i];
        }
      }
    }
  }
}

// The prefix table of a non-empty library into start (n_buckets + 1).
cudaError_t launch_prefix_table(const int64_t* lib, int64_t lib_size,
                                int64_t n_buckets, int32_t* start,
                                cudaStream_t st) {
  if (lib_size <= 0) return cudaSuccess;
  prefix_table_kernel<<<static_cast<unsigned>((lib_size + 256) / 256), 256,
                        0, st>>>(lib, lib_size, n_buckets, start);
  return cudaGetLastError();
}

// Shared-memory bytes of the sign form's parts' sums for d columns, `per`
// columns a group.
int sum_bytes(int64_t d, int64_t per) {
  const int64_t n_groups = (d + per - 1) / per;
  const int64_t groups = n_groups < THREADS ? n_groups : THREADS;
  return static_cast<int>((THREADS / groups) * 2 * per * groups *
                          sizeof(float));
}

// The dense sweep's launches: g rows of `parts` warps a block, in waves of
// at most the
// blocks the card holds at once (each a cooperative launch, so a block that
// waits for the others waits for blocks that run), the step counters
// zeroed before each.
template <typename T, int PER>
cudaError_t launch_sweep(const uint32_t* hits, int64_t h, const int32_t* bnd,
                         int nw, int64_t rows, int g, int parts,
                         const void* table, int64_t d,
                         const int64_t* targets, float* out, int32_t* done,
                         int lag, cudaStream_t st) {
  auto kernel = dense_sweep_kernel<T, PER>;
  const int threads = 32 * g * parts;
  const int smem = g * (parts - 1) * 32 * 32 * 4;
  // the blocks an SM holds, by device and block shape, asked once (a launch
  // that sizes its waves on every call pays for the query each time)
  static int resident[16][DENSE_WARPS_MAX + 1][DENSE_WARPS_MAX + 1] = {};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  int* per_sm = dev < 16 ? &resident[dev][g][parts] : nullptr;
  int asked = 0;
  if (per_sm == nullptr || *per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&asked, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm != nullptr) *per_sm = asked;
  } else {
    asked = *per_sm;
  }
  if (asked < 1) return cudaErrorInvalidConfiguration;
  const int64_t steps = (d + DENSE_COLS - 1) / DENSE_COLS * nw;
  const int64_t groups = (rows + g - 1) / g;
  const int64_t most = static_cast<int64_t>(asked) * sms;
  const T* tab = static_cast<const T*>(table);
  for (int64_t g0 = 0; g0 < groups; g0 += most) {
    const int grid = static_cast<int>(groups - g0 < most ? groups - g0 : most);
    int64_t row0 = g0 * g;
    err = cudaMemsetAsync(done, 0, steps * sizeof(int32_t), st);
    if (err != cudaSuccess) return err;
    void* args[] = {&hits, &h, &bnd, &nw, &rows, &row0, &parts, &tab, &d,
                    &targets, &out, &done, &lag};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(grid), dim3(threads), args, smem,
                                      st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// start: int32 scratch of n_buckets + 1 entries (n_buckets a power of two,
// membership_embed's pow2(lib_size)), the prefix table, rebuilt by the
// first launch; then one block per staged row.
extern "C" int fk_membership_embed(const int64_t* staged, int64_t rows,
                                   int64_t h, const int64_t* lib,
                                   int64_t lib_size, const int32_t* signs,
                                   int64_t n_words, const float* mags,
                                   int64_t d, const int64_t* targets,
                                   float* out, int32_t* n_hits,
                                   int32_t* start, int64_t n_buckets,
                                   void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_prefix_table(lib, lib_size, n_buckets,
                                              start, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  membership_embed_kernel<<<static_cast<unsigned>(rows), THREADS,
                            sum_bytes(d, 16), st>>>(
      staged, h, lib, lib_size, start, n_buckets,
      reinterpret_cast<const uint32_t*>(signs), n_words, mags, d, targets,
      out, n_hits);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C's dense form over a dense paired table (L+1, 2d) of float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1) entries: the same prefix table
// (start, n_buckets), then dense_hits_kernel (one block per staged row;
// scratch hits (rows, h) int32 and bnd (rows, nw + 1) int32), then the
// sweep (dense_sweep_kernel<T, per>: g staged rows a block, `parts` warps
// each, columns in chunks of DENSE_COLS, windows of ws library rows, nw =
// ceil(lib_size / ws) of them, a block at most lag windows ahead of the
// slowest; scratch done, ceil(d / DENSE_COLS) * nw int32). Staged rows are
// sorted (every staging path writes them so). per > 1 needs d a multiple
// of per and a table aligned to per entries.
extern "C" int fk_membership_embed_dense(
    const int64_t* staged, int64_t rows, int64_t h, const int64_t* lib,
    int64_t lib_size, const void* table, int is_bf16, int64_t d,
    const int64_t* targets, float* out, int32_t* n_hits, int32_t* start,
    int64_t n_buckets, int32_t* hits, int32_t* bnd, int32_t* done, int g,
    int parts, int per, int64_t ws, int nw, int lag, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const int64_t size = is_bf16 ? 2 : 4;
  if (g < 1 || parts < 1 || g * parts > DENSE_WARPS_MAX || per < 1 ||
      per * size > 16 ||
      (per > 1 && (d % per != 0 ||
                   reinterpret_cast<uintptr_t>(table) % (per * size) != 0)) ||
      ws < 1 || nw < 1 || (nw - 1) * ws >= (lib_size > 0 ? lib_size : 1) ||
      lag < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_prefix_table(lib, lib_size, n_buckets, start, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_hits_kernel<<<static_cast<unsigned>(rows), THREADS, 0, st>>>(
      staged, h, lib, lib_size, start, n_buckets, ws, nw,
      reinterpret_cast<uint32_t*>(hits), bnd, n_hits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t* hl = reinterpret_cast<const uint32_t*>(hits);
#define FK_SWEEP(T, P)                                                        \
  launch_sweep<T, P>(hl, h, bnd, nw, rows, g, parts, table, d, targets, out, \
                     done, lag, st)
  if (is_bf16) {
    err = per == 8   ? FK_SWEEP(uint16_t, 8)
          : per == 4 ? FK_SWEEP(uint16_t, 4)
          : per == 2 ? FK_SWEEP(uint16_t, 2)
          : per == 1 ? FK_SWEEP(uint16_t, 1)
                     : cudaErrorInvalidValue;
  } else {
    err = per == 4   ? FK_SWEEP(float, 4)
          : per == 2 ? FK_SWEEP(float, 2)
          : per == 1 ? FK_SWEEP(float, 1)
                     : cudaErrorInvalidValue;
  }
#undef FK_SWEEP
  return static_cast<int>(err);
}
