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
// per hit as the plain version's embed_hits_paired does. It shares the
// prefix table, the lookups and the hit lists above; only the
// accumulation differs. Every hit now reads a whole 2d-wide row (4,096
// bytes at d = 512 in float32), so the work no longer follows the
// nonzeros and the bound is the bytes of the rows: a thread owns 16
// bytes of consecutive columns (4 float32 or 8 bfloat16) of both halves
// and walks its part of each tile's hit list in slot order with UNROLL
// hits' 16-byte loads in flight (entry by entry where d is not a
// multiple of 4 or 8), adding left to fwd and right to rev (swapped for a
// reverse-strand hit) in float32 registers. After the last tile the parts
// are added in part order through shared memory, so every column's order
// is fixed and two launches give the same bytes. Past 256 threads'
// columns, the columns are taken in chunks, each redoing the lookups.

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

// The 16 bytes of table entries p[0, n) (n <= 16 / sizeof(T); entries past
// n read as zero): one 16-byte load when `vec`, else entry by entry. T is
// float, or uint16_t holding a bfloat16's bits.
template <typename T>
__device__ __forceinline__ uint4 load_cols(const T* __restrict__ p, int n,
                                           bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = i < n ? __float_as_uint(__ldg(p + i)) : 0u;
    } else {
      const uint32_t a = 2 * i < n ? __ldg(p + 2 * i) : 0u;
      const uint32_t b = 2 * i + 1 < n ? __ldg(p + 2 * i + 1) : 0u;
      w[i] = a | (b << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// acc[i] += entry i of the 16 bytes `raw`, in float32 (a bfloat16 is the
// high half of its float32).
template <typename T>
__device__ __forceinline__ void add_cols(uint4 raw, float* acc) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      acc[i] += __uint_as_float(w[i]);
    } else {
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
membership_embed_dense_kernel(const int64_t* __restrict__ staged,
                              int64_t h, const int64_t* __restrict__ lib,
                              int64_t lib_size,
                              const int32_t* __restrict__ start,
                              int64_t n_buckets, const T* __restrict__ table,
                              int64_t d, const int64_t* __restrict__ targets,
                              float* __restrict__ out,
                              int32_t* __restrict__ n_hits) {
  constexpr int N = 16 / sizeof(T);  // columns a thread owns in each half
  extern __shared__ float sums[];    // parts x (fwd, rev) x cols
  __shared__ uint32_t hit_list[TILE];
  __shared__ int scratch[2][33];
  const int64_t n_groups = (d + N - 1) / N;
  // 16-byte loads need both halves of every row on 16-byte boundaries
  const bool vec =
      d % N == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const int shift = lib_size > 0 ? bucket_shift(lib, lib_size, n_buckets) : 0;

  int scan = 0;  // which scratch array the next block_scan takes
  const int64_t r = blockIdx.x;
  const int64_t* row = staged + r * h;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  for (int64_t g0 = 0; g0 < n_groups; g0 += THREADS) {
    const int groups = static_cast<int>(
        n_groups - g0 < THREADS ? n_groups - g0 : THREADS);
    const int parts = THREADS / groups;
    const int cols = N * groups;
    const int own_g = threadIdx.x % groups;
    const int part = threadIdx.x / groups;
    const int64_t c0 = N * (g0 + own_g);  // this thread's first column
    const int n = d - c0 < N ? static_cast<int>(d - c0) : N;
    float fwd[N], rev[N];
#pragma unroll
    for (int i = 0; i < N; ++i) fwd[i] = rev[i] = 0.f;
    int total = 0;
    for (int64_t t0 = 0; t0 < h; t0 += TILE) {
      const int count = tile_hits(row, h, t0, aligned, lib, lib_size, start,
                                  n_buckets, shift, hit_list, scratch,
                                  &scan);
      total += count;
      // 3. this part's hits in slot order, UNROLL rows' loads in flight
      if (part < parts) {
        for (int e0 = part; e0 < count; e0 += UNROLL * parts) {
          uint32_t ent[UNROLL];
          uint4 left[UNROLL], right[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int e = e0 + u * parts;
            ent[u] = e < count ? hit_list[e] : 0u;
            left[u] = right[u] = make_uint4(0u, 0u, 0u, 0u);
            if (e < count) {
              const T* p = table + static_cast<int64_t>(ent[u] & 0x7FFFFFFFu)
                                       * (2 * d) + c0;
              left[u] = load_cols(p, n, vec);
              right[u] = load_cols(p + d, n, vec);
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (e0 + u * parts >= count) continue;
            const bool swap = ent[u] >> 31;
            add_cols<T>(swap ? right[u] : left[u], fwd);
            add_cols<T>(swap ? left[u] : right[u], rev);
          }
        }
      }
      __syncthreads();  // hit_list is refilled by the next tile
    }
    if (part < parts) {
      float* f = sums + (2 * part) * cols + N * own_g;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        f[i] = fwd[i];
        f[cols + i] = rev[i];
      }
    }
    __syncthreads();
    // the parts' partial sums, added in part order
    const int64_t t_fwd = targets[2 * r];
    const int64_t t_rev = targets[2 * r + 1];
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const int64_t col = N * g0 + c;
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
    __syncthreads();  // sums are rewritten by the next column chunk
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

// Shared-memory bytes of the parts' sums for d columns, `per` columns a
// group (16 for the sign form, 16 bytes of entries for the dense form).
int sum_bytes(int64_t d, int64_t per) {
  const int64_t n_groups = (d + per - 1) / per;
  const int64_t groups = n_groups < THREADS ? n_groups : THREADS;
  return static_cast<int>((THREADS / groups) * 2 * per * groups *
                          sizeof(float));
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

// Kernel C's dense form: the same prefix table (start, n_buckets) and row
// blocks over a dense paired table (L+1, 2d) of float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1) entries.
extern "C" int fk_membership_embed_dense(const int64_t* staged, int64_t rows,
                                         int64_t h, const int64_t* lib,
                                         int64_t lib_size, const void* table,
                                         int is_bf16, int64_t d,
                                         const int64_t* targets, float* out,
                                         int32_t* n_hits, int32_t* start,
                                         int64_t n_buckets, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_prefix_table(lib, lib_size, n_buckets,
                                              start, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows));
  if (is_bf16) {
    membership_embed_dense_kernel<uint16_t><<<grid, THREADS,
                                              sum_bytes(d, 8), st>>>(
        staged, h, lib, lib_size, start, n_buckets,
        static_cast<const uint16_t*>(table), d, targets, out, n_hits);
  } else {
    membership_embed_dense_kernel<float><<<grid, THREADS, sum_bytes(d, 4),
                                           st>>>(
        staged, h, lib, lib_size, start, n_buckets,
        static_cast<const float*>(table), d, targets, out, n_hits);
  }
  return static_cast<int>(cudaGetLastError());
}
