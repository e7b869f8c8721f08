// K10: the k-NN result wire (knn/topk.py keys_to_host on a card).
//
// Replaces the JAX package's device stages of the result's trip to the
// host: quantize_dist (fedrann_tpu/knn/topk.py:36) and _idx_u16 (:58),
// run inside transfer_dist (:49) and transfer_idx (:95), jitted XLA
// element-wise passes; no pl.pallas_call. The port keeps a search's
// result as (rows, k) int64 keys (topk._order_keys: the score's float32
// bits made monotone in the high word, the complemented candidate index
// in the low word). One launch turns each key into the two values that
// keys_to_host_plain returns, byte for byte:
//   index     0xFFFFFFFF - (key & 0xFFFFFFFF) as int32 (its low 16 bits
//             where the indices cross as uint16: n_rows <= 65,536 under
//             the u16 wire), -1 at EMPTY_KEY;
//   distance  1 - score in float32 on the f32 wire, inf at EMPTY_KEY; on
//             the u16 wire q * float32(1 / 32767.5), q = clip(rint((1 -
//             score) * 32767.5), 0, 65535) as an integer (a score past 1
//             gives q = 0 and +0.0, never -0.0), 65535 at EMPTY_KEY.
// Rounding is the framework's: round half to even (rintf), each step
// rounded alone (__fsub_rn, __fmul_rn: nothing contracts into an FMA),
// and the dequantizing factor has the bits of np.float32(1 / 32767.5).
//
// The kernel writes the final int32 indices and float32 distances
// straight into page-locked host memory (a block of torch's caching host
// allocator, or for a large result a block of its own from
// fk_host_alloc; mapped into the card's address space either way), so
// nothing is left
// for the host to do per entry: no empty mask, no widening of a uint16
// wire, no dequantizing pass. A thread takes four keys (two 16-byte
// loads) and stores four indices and four distances as one 16-byte store
// each, so a warp's stores leave the card as whole 128-byte lines.
//
// Bound on the card: the bytes crossing to the host, 8 an entry (4 for
// the index, 4 for the distance), over the host link's nominal rate (PCIe
// Gen5 x16: 32 GT/s a lane, 128b/130b, 63.0 GB/s each way); the keys' 8
// bytes an entry read from device memory take ~2% of that.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr long long EMPTY_KEY = static_cast<long long>(INT64_MIN);
constexpr int THREADS = 256;
constexpr int VEC = 4;  // keys a thread
constexpr float DIST_SCALE = 32767.5f;

// np.float32(1.0 / 32767.5)
__device__ __forceinline__ float inv_scale() {
  return __uint_as_float(0x38000080u);
}

template <bool U16_DIST, bool U16_IDX>
__device__ __forceinline__ void decode(long long key, int& idx,
                                       float& dist) {
  const bool empty = key == EMPTY_KEY;
  const uint32_t id = 0xFFFFFFFFu - static_cast<uint32_t>(key);
  const int mono = static_cast<int>(key >> 32);
  const float score = __int_as_float(mono < 0 ? mono ^ 0x7FFFFFFF : mono);
  const float d = __fsub_rn(1.0f, score);
  if (U16_DIST) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(d, DIST_SCALE)), 0.0f),
                          65535.0f);
    // through an integer, as the wire carries it: -0.0 becomes 0
    const int step = empty ? 65535 : static_cast<int>(q);
    dist = __fmul_rn(static_cast<float>(step), inv_scale());
  } else {
    dist = empty ? __int_as_float(0x7F800000) : d;
  }
  idx = empty ? -1 : static_cast<int>(U16_IDX ? (id & 0xFFFFu) : id);
}

template <bool U16_DIST, bool U16_IDX, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    keys_to_host_kernel(const long long* __restrict__ keys, int64_t n,
                        int* __restrict__ idx, float* __restrict__ dist) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  if (i >= n) return;
  if (VECTOR && i + VEC <= n) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(keys + i));
    const longlong2 b =
        __ldcs(reinterpret_cast<const longlong2*>(keys + i + 2));
    int4 oi;
    float4 od;
    decode<U16_DIST, U16_IDX>(a.x, oi.x, od.x);
    decode<U16_DIST, U16_IDX>(a.y, oi.y, od.y);
    decode<U16_DIST, U16_IDX>(b.x, oi.z, od.z);
    decode<U16_DIST, U16_IDX>(b.y, oi.w, od.w);
    *reinterpret_cast<int4*>(idx + i) = oi;
    *reinterpret_cast<float4*>(dist + i) = od;
    return;
  }
  const int64_t end = n < i + VEC ? n : i + VEC;
  for (int64_t j = i; j < end; ++j) {
    decode<U16_DIST, U16_IDX>(keys[j], idx[j], dist[j]);
  }
}

template <bool U16_DIST, bool U16_IDX>
cudaError_t launch(const long long* keys, int64_t n, int* idx, float* dist,
                   bool vector, cudaStream_t s) {
  const int64_t threads = (n + VEC - 1) / VEC;
  const unsigned blocks =
      static_cast<unsigned>((threads + THREADS - 1) / THREADS);
  if (vector) {
    keys_to_host_kernel<U16_DIST, U16_IDX, true>
        <<<blocks, THREADS, 0, s>>>(keys, n, idx, dist);
  } else {
    keys_to_host_kernel<U16_DIST, U16_IDX, false>
        <<<blocks, THREADS, 0, s>>>(keys, n, idx, dist);
  }
  return cudaGetLastError();
}

// The address the card writes p through: p itself under unified
// addressing, checked to be page-locked host memory (a pageable pointer
// would fault in the kernel).
cudaError_t mapped(void** p) {
  cudaPointerAttributes at;
  const cudaError_t err = cudaPointerGetAttributes(&at, *p);
  if (err != cudaSuccess) return err;
  if (at.type != cudaMemoryTypeHost || at.devicePointer == nullptr) {
    return cudaErrorInvalidValue;
  }
  *p = at.devicePointer;
  return cudaSuccess;
}

// The launch of fk_keys_to_host once idx and dist are addresses the card
// writes through.
cudaError_t keys_to(const long long* keys, int64_t n, int u16_dist,
                    int u16_idx, int* idx, float* dist, cudaStream_t s) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vector = aligned(keys) && aligned(idx) && aligned(dist);
  if (u16_dist) {
    return u16_idx ? launch<true, true>(keys, n, idx, dist, vector, s)
                   : launch<true, false>(keys, n, idx, dist, vector, s);
  }
  return u16_idx ? launch<false, true>(keys, n, idx, dist, vector, s)
                 : launch<false, false>(keys, n, idx, dist, vector, s);
}

}  // namespace

// n int64 keys -> n int32 indices and n float32 distances, in one launch
// on `stream`, written into idx and dist: page-locked host memory
// (checked), which the kernel writes through the card's mapping.
// u16_dist: the distances on the u16 grid; u16_idx: the indices as they
// cross in uint16 (their low 16 bits).
extern "C" int fk_keys_to_host(const long long* keys, int64_t n,
                               int u16_dist, int u16_idx, int* idx,
                               float* dist, void* stream) {
  if (n < 0 || (n + VEC - 1) / VEC / THREADS >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = mapped(reinterpret_cast<void**>(&idx));
  if (err == cudaSuccess) err = mapped(reinterpret_cast<void**>(&dist));
  if (err == cudaSuccess) {
    err = keys_to(keys, n, u16_dist, u16_idx, idx, dist,
                  static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(err);
}

// A page-locked host block of `bytes` into *out, mapped for every card:
// a result too large for torch's caching host allocator (knn/topk.py
// PIN_CACHE_BYTES), which rounds a block up to a power of two and keeps
// it; this one goes back to the system with fk_host_free.
extern "C" int fk_host_alloc(int64_t bytes, void** out) {
  return static_cast<int>(cudaHostAlloc(
      out, static_cast<size_t>(bytes),
      cudaHostAllocMapped | cudaHostAllocPortable));
}

extern "C" int fk_host_free(void* p) {
  return static_cast<int>(cudaFreeHost(p));
}
