// Kernel A: canonical window codes + sampling filter -> the (R, W) plane of
// staged slots.
//
// Replaces the TPU kernel `canonical_and_sample` (bench/pallas_kernels.py:93,
// its pallas_call :128, body `_kernel` :42), meeting the production
// contract of fedrann_tpu/kmers/codec.py `canonical_window_codes` plus the
// `sample_hash32 < threshold` filter of membership.select_candidates, for
// every k <= 31 (one int64 slot per window, no u32 word tuples).
//
// Since kernel B's one-block path computes its slots itself from the bases
// (select_stage_rows.cu, `fk_stage_rows`), this kernel serves only the rows
// that path cannot hold: B's device-memory path reads the plane it writes
// (keep_all rows past 28,928 windows, blocked rows at >= 6.5% sampling at
// the 262,144-base bucket and >= 14.5% at 131,072;
// membership.stage_launch_plan decides).
//
// One block of 256 threads per (row, 1024-window block): window_slots
// (window_codes.cuh) stages the block's bases and halo from the row's
// source (a byte matrix, or the packer's 2-bit stream with the row's
// length or its valid bits) as a 2-bit stream and an invalid mask in
// shared memory, and gives each thread its 4 windows' slots in O(1)
// operations each; a block whose bases are all INVALID skips the codes and
// hashes. The thread stores its 4 slots with 16-byte stores where the row
// is aligned.
//
// Bound on the card: the larger of the bytes (one byte of bases, or a
// quarter byte packed, in and 8 bytes of slots out per window: 0.090 ms
// from bytes at the main path's 2,048 x 16,384 chunk) and the integer work
// (WINDOW_INSTR_* + STAGE_INSTR_* + HASH_INSTR_* of window_codes.cuh per
// window over 132 SMs x 64 INT32 lanes x 1.98 GHz), which chip_smoke.py
// prints beside its time. Writing the plane is the point of this form, so
// the bytes stay.

#include "window_codes.cuh"

namespace {

constexpr int A_THREADS = 256;

// This thread's PER slots of 1024-window block b of a row of w slots
// (nothing past w), with 16-byte stores where the row is aligned.
template <int PER>
__device__ __forceinline__ void store_slots(int64_t* row, int64_t w,
                                            int64_t b,
                                            const int64_t (&v)[PER]) {
  const int64_t c = b * SELECT_BLOCK + PER * threadIdx.x;
  if (PER % 2 == 0 && aligned16(row) && c + PER <= w) {
    longlong2* p = reinterpret_cast<longlong2*>(row + c);
#pragma unroll
    for (int i = 0; i < PER / 2; ++i)
      p[i] = make_longlong2(v[2 * i], v[2 * i + 1]);
    return;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (c + i < w) row[c + i] = v[i];
}

template <bool WIDE, int SRC>
__global__ void __launch_bounds__(A_THREADS)
canonical_sample_kernel(WindowParams p, int n_blocks,
                        int64_t* __restrict__ out) {
  constexpr int PER = SELECT_BLOCK / A_THREADS;
  __shared__ WindowStage stage;
  const int64_t r = blockIdx.x / n_blocks;
  const int64_t b = blockIdx.x - r * n_blocks;
  const int c =
      threadIdx.x < WINDOW_CHUNKS ? static_cast<int>(threadIdx.x) : -1;
  WindowChunk chunk{};
  if (c >= 0) {
    const RowSource<SRC> src(p, r);
    chunk = RowSource<SRC>::chunk(src.fetch(b, c));
  }
  int64_t v[PER];
  window_slots<PER, WIDE>(p, b, c, chunk, stage, v);
  store_slots(out + r * p.w, p.w, b, v);
}

template <bool WIDE>
void launch_canonical_sample(const WindowParams& p, int src, unsigned grid,
                             int n_blocks, int64_t* out, cudaStream_t st) {
  if (src == SRC_PACKED) {
    canonical_sample_kernel<WIDE, SRC_PACKED>
        <<<grid, A_THREADS, 0, st>>>(p, n_blocks, out);
  } else if (src == SRC_BITS) {
    canonical_sample_kernel<WIDE, SRC_BITS>
        <<<grid, A_THREADS, 0, st>>>(p, n_blocks, out);
  } else {
    canonical_sample_kernel<WIDE, SRC_BYTES>
        <<<grid, A_THREADS, 0, st>>>(p, n_blocks, out);
  }
}

}  // namespace

// src (SRC_BYTES, SRC_PACKED or SRC_BITS of window_codes.cuh) says what
// `bases` and `aux` hold (WindowParams). s1 = fmix32(seed32), s2 =
// fmix32(s1 ^ 0x9E3779B9), computed by the caller.
extern "C" int fk_canonical_sample(const uint8_t* bases, const void* aux,
                                   int src, int64_t rows, int64_t length,
                                   int64_t w, int k, uint32_t s1, uint32_t s2,
                                   uint32_t threshold, int keep_all,
                                   int64_t* out, void* stream) {
  if (rows <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (src < SRC_BYTES || src > SRC_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = static_cast<int>((w + SELECT_BLOCK - 1) / SELECT_BLOCK);
  const WindowParams p{bases, aux, length,
                       src == SRC_BYTES ? length : (length + 3) / 4,
                       w, k, s1, s2, threshold, keep_all};
  const unsigned grid = static_cast<unsigned>(rows * n_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > 16) {
    launch_canonical_sample<true>(p, src, grid, n_blocks, out, st);
  } else {
    launch_canonical_sample<false>(p, src, grid, n_blocks, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
