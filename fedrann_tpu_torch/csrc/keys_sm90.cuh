// What the k-NN kernels share (knn_merge.cu's K4, ivf_rescore.cu's K6 and
// K7): the int64 keys of knn/topk.py `_order_keys`, the wgmma pieces of a
// bf16 product on 128-byte swizzled shared-memory tiles, and warp-wide
// bitonic networks over keys held in registers.
//
// A key is the float32 score's bits made monotone in the high word and lo
// = 0xFFFFFFFF - index in the low word, so keys order by (score desc,
// index asc); EMPTY_KEY, an unset slot, is below every key a score makes.
//
#pragma once

#include <cstdint>

namespace {

constexpr int64_t EMPTY_KEY = INT64_MIN;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ int64_t kmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t kmin(int64_t a, int64_t b) {
  return a < b ? a : b;
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

// ------------------------------------------------------------- wgmma --

// wgmma's descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1 KB apart (SBO), LBO 16 bytes (unused there).
// The 16-byte piece c of row r sits at piece c ^ (r & 7) of the row, from
// a 1024-byte aligned base: what TMA's 128-byte swizzle writes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie the accumulators to this point of the program (the compiler may not
// move their reads or writes across it).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) * B (128 x 16, K-major)^T, bf16 in, f32 out;
// scale-d = 1 always (the accumulators start at +0.0). In the result a
// thread of warp w of the warpgroup holds rows 16 w + lane / 4 (d[4 j],
// d[4 j + 1]) and 8 below (d[4 j + 2], d[4 j + 3]), columns 8 j + 2 (lane
// % 4) and the next.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------- bitonic networks --
//
// A run of T = G R keys held by a group of G lanes (G a power of two up to
// 32, the groups aligned in the warp), R registers each: element e = G i +
// j in register i of the group's lane j = lane % G. Steps of span d < G
// shuffle within the group; longer ones swap registers of a lane. Every
// lane of the warp calls them (they shuffle with the full mask), each
// group on its own run.

// Sort the run descending (a bitonic sort: merges of size k, each a
// descending block where bit k of e is clear, else an ascending one).
template <int R, int G = 32>
__device__ __forceinline__ void sort_desc(int64_t (&v)[R], int j) {
#pragma unroll
  for (int k = 2; k <= G * R; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool desc = (((G * i + j) & k) == 0);
        if (d >= G) {
          const int pi = i ^ (d / G);
          if (pi > i) {
            const int64_t hi = kmax(v[i], v[pi]), lo = kmin(v[i], v[pi]);
            v[i] = desc ? hi : lo;
            v[pi] = desc ? lo : hi;
          }
        } else {
          const int64_t p = __shfl_xor_sync(0xffffffffu, v[i], d);
          // the lower lane of a pair keeps the larger key in a descending
          // block, the smaller in an ascending one
          v[i] = (((j & d) == 0) == desc) ? kmax(v[i], p) : kmin(v[i], p);
        }
      }
    }
  }
}

// Sort a bitonic run descending (the half-cleaners of spans T / 2 .. 1).
template <int R, int G = 32>
__device__ __forceinline__ void clean_desc(int64_t (&v)[R], int j) {
#pragma unroll
  for (int d = G * R / 2; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (d >= G) {
        const int pi = i ^ (d / G);
        if (pi > i) {
          const int64_t hi = kmax(v[i], v[pi]);
          v[pi] = kmin(v[i], v[pi]);
          v[i] = hi;
        }
      } else {
        const int64_t p = __shfl_xor_sync(0xffffffffu, v[i], d);
        v[i] = (j & d) == 0 ? kmax(v[i], p) : kmin(v[i], p);
      }
    }
  }
}

// a := the top T keys of the runs a and b, both sorted descending, sorted
// descending: the larger of a[e] and b[T - 1 - e] (a bitonic run holding
// them; element T - 1 - e sits in register R - 1 - i of lane G - 1 - j),
// then a clean.
template <int R, int G = 32>
__device__ __forceinline__ void merge_top(int64_t (&a)[R],
                                          const int64_t (&b)[R], int j) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    a[i] = kmax(a[i], __shfl_xor_sync(0xffffffffu, b[R - 1 - i], G - 1));
  }
  clean_desc<R, G>(a, j);
}

// One warp's descending sort of 32 keys, a lane each.
__device__ __forceinline__ int64_t sort32(int64_t v, int lane) {
  int64_t a[1] = {v};
  sort_desc<1>(a, lane);
  return a[0];
}

}  // namespace
