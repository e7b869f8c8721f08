// Kernel C: library membership + sign-packed paired embedding.
//
// Replaces the TPU kernel `merge_embed` (bench/pallas_embed.py:212, `_kernel`
// :86, `build_q_cat` :72, `prepare_library` :303) and computes what its
// production twin computes: fedrann_tpu/kmers/membership.py
// `_read_hits_staged` (:367) followed by project/embed.py
// `embed_hits_paired_signs` (:223), scattered into the fwd/rev rows of the
// (2N, d) embedding matrix as pipeline._embed_group_scan does. Codes are
// int64 for every k <= 31, and the projection is the 2-bit sign table times
// a per-row magnitude (srp.build_precompute_signs), not a dense f32 table.
//
// One thread block per staged row, in tiles of blockDim slots:
//   1. each thread resolves one slot: padding and a slot equal to its left
//      neighbour (a repeat of the same (code, strand)) are skipped; the code
//      is binary-searched in the sorted int64 library; a hit is compacted,
//      in slot order (warp ballots + a block prefix), into shared memory as
//      j | swap << 31 (swap = the window was the reverse complement);
//   2. each thread owns output columns and walks the tile's hits in order,
//      unpacking the 2-bit signs of row j (field c and field d + c) times
//      mags[j], adding P[j] and P[j+L] to its fwd and rev sums, halves
//      swapped for a reverse-strand hit.
// The sum order of every column is the slot order, so the result is
// deterministic. Rows with target -1 (padding reads) are not written.
//
// Bound on the card: the library binary searches (log2 L dependent loads
// per candidate; the sorted library, 8 bytes a code, stays in L2 at the
// main path's sizes) and the per-hit sign-row reads, which 16 threads share
// per 32-bit word. Columns beyond blockDim loop and redo the tile's
// searches.

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

__global__ void membership_embed_kernel(
    const int64_t* __restrict__ staged, int64_t h,
    const int64_t* __restrict__ lib, int64_t lib_size,
    const uint32_t* __restrict__ signs, int64_t n_words,
    const float* __restrict__ mags, int64_t d,
    const int64_t* __restrict__ targets, float* __restrict__ out,
    int32_t* __restrict__ n_hits) {
  __shared__ uint32_t hit_list[MAX_THREADS];
  __shared__ int warp_base[MAX_THREADS / 32];
  __shared__ int tile_hits;
  const int64_t r = blockIdx.x;
  const int64_t* row = staged + r * h;
  const int64_t t_fwd = targets[2 * r];
  const int64_t t_rev = targets[2 * r + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int total = 0;

  for (int64_t c0 = 0; c0 < d; c0 += blockDim.x) {
    const int64_t c = c0 + threadIdx.x;
    float acc_f = 0.f, acc_r = 0.f;
    total = 0;
    for (int64_t t0 = 0; t0 < h; t0 += blockDim.x) {
      const int64_t i = t0 + threadIdx.x;
      bool hit = false;
      uint32_t entry = 0;
      if (i < h) {
        const int64_t s = row[i];
        if (s != PAD_SLOT && !(i > 0 && row[i - 1] == s)) {
          const int64_t code = s >> 1;
          int64_t lo = 0, hi = lib_size;
          while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (lib[mid] < code) lo = mid + 1; else hi = mid;
          }
          if (lo < lib_size && lib[lo] == code) {
            hit = true;
            entry = static_cast<uint32_t>(lo) | ((s & 1) ? 0u : 0x80000000u);
          }
        }
      }
      // order-preserving compaction of this tile's hits
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_base[warp] = __popc(mask);
      __syncthreads();
      if (threadIdx.x == 0) {
        int run = 0;
        for (int wi = 0; wi < n_warps; ++wi) {
          const int n = warp_base[wi];
          warp_base[wi] = run;
          run += n;
        }
        tile_hits = run;
      }
      __syncthreads();
      if (hit)
        hit_list[warp_base[warp] + __popc(mask & ((1u << lane) - 1u))] = entry;
      __syncthreads();
      const int n = tile_hits;
      total += n;
      if (c < d) {
        const int64_t cr = d + c;
        for (int e = 0; e < n; ++e) {
          const uint32_t ent = hit_list[e];
          const int64_t j = ent & 0x7FFFFFFFu;
          const uint32_t* srow = signs + j * n_words;
          const uint32_t fl = (srow[c >> 4] >> (2 * (c & 15))) & 3u;
          const uint32_t fr = (srow[cr >> 4] >> (2 * (cr & 15))) & 3u;
          const float m = mags[j];
          const float vl = fl == 1u ? m : (fl == 2u ? -m : 0.f);
          const float vr = fr == 1u ? m : (fr == 2u ? -m : 0.f);
          if (ent >> 31) {
            acc_f += vr;
            acc_r += vl;
          } else {
            acc_f += vl;
            acc_r += vr;
          }
        }
      }
      __syncthreads();  // hit_list and warp_base are reused by the next tile
    }
    if (c < d) {
      if (t_fwd >= 0) out[t_fwd * d + c] = acc_f;
      if (t_rev >= 0) out[t_rev * d + c] = acc_r;
    }
  }
  if (threadIdx.x == 0) n_hits[r] = total;
}

}  // namespace

// threads: min(1024, d rounded up to a warp) so one column chunk covers d.
extern "C" int fk_membership_embed(const int64_t* staged, int64_t rows,
                                   int64_t h, const int64_t* lib,
                                   int64_t lib_size, const int32_t* signs,
                                   int64_t n_words, const float* mags,
                                   int64_t d, const int64_t* targets,
                                   float* out, int32_t* n_hits,
                                   void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  int64_t threads = (d + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if (threads < 32) threads = 32;
  membership_embed_kernel<<<static_cast<unsigned>(rows),
                            static_cast<unsigned>(threads), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      staged, h, lib, lib_size, reinterpret_cast<const uint32_t*>(signs),
      n_words, mags, d, targets, out, n_hits);
  return static_cast<int>(cudaGetLastError());
}
