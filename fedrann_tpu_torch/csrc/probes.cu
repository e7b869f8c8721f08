// Capability probes: the counterparts of the Mosaic probes of
// bench/probe_mosaic.py and bench/probe_mosaic2.py on Hopper. Each is a
// micro-kernel whose answer says what one access pattern of the staging
// and embed kernels costs on this card:
//
//   fk_probe_smem_scratch  (P1, probe_mosaic.py:32 `probe_smem_scratch`):
//     a block with n int32 of dynamic shared memory fills all of it with n
//     (up to 1,024 threads, 16-byte stores) and returns its last entry.
//     Sizes past the opt-in limit are refused by cudaFuncSetAttribute (a
//     non-sticky error, cleared before returning). Bound: the launch; the
//     fill is at most ~15 stores a thread;
//   fk_probe_smem_input    (P2 probe_mosaic.py:55, P5 probe_mosaic2.py:30):
//     one block per grid step stages its whole (rb, hb) int32 block in
//     shared memory (what the probe measures: the TPU's input BlockSpec
//     placed the block in SMEM) and sums x_blk[i, i & 1023] for i < rb;
//     the last n_sums steps write their sums (the TPU kernel overwrote one
//     output, so its value is the last step's). 1,024 threads each issue
//     all of their 16-byte ld.global.nc loads (8 for 128 KB) before any
//     shared-memory store, so the whole block is in flight at once: ~0.3
//     us a launch faster than TMA bulk copies onto an mbarrier, in 1 to 8
//     pieces (PERF.md). A block off 16 bytes takes 4-byte loads. Warp 0
//     then sums the diagonal with one warp reduction (uint32, so it wraps
//     like the TPU's int32 adds; integer addition is order-free). Bound:
//     one SM pulling the block (128 KB) from L2, and the launch;
//   fk_probe_dyn_rows      (P3 probe_mosaic.py:92, P6 probe_mosaic2.py:47):
//     the dynamic-row gather-accumulate of kernel C: e starts at zero, then
//     `steps` times over the nh hits in order, e[dst] = e[dst] + q[src] (or
//     e[dst] = q[src] when not accumulating), src = idx[i] or row 0, dst =
//     row[i] or row 0. No float atomics: every output cell sums its own
//     hits in hit order, the TPU's sequential fori_loop order, so the
//     result equals that order bitwise. Two kernels, one per kind of mode:
//     - dynamic rows (P3, B, C): one block of 1,024 threads per output row
//       r. The block compacts, in hit order (warp ballots plus a block
//       prefix, common.cuh block_compact), the sources of the hits with
//       row[i] == r into a shared-memory list, 8,192 hits at a time, then
//       each thread owns a column and walks the list `steps` times with
//       its sum in a register (past one chunk, the partial sum waits in e
//       between chunks; the same thread reads it back). Bound: the q-row
//       gathers from L2 (steps x nh x d x 4 bytes; q stays in L2) and the
//       reads of row[] that every block makes (nh x 4 bytes a block);
//     - fixed row (A): every hit lands in row 0, one chain of nh x steps
//       dependent adds per column that no split may reorder. Blocks of
//       32 columns (one 128-byte line of a q row) spread the columns over
//       the card; the hit sources sit in shared memory, 4,096 at a time,
//       and while warp 0 sums a batch of 256 hits' q strips, loading 32
//       values ahead of its adds, warps 1-7 start copying the batch after
//       next with cp.async (16-byte pieces where q's rows are aligned;
//       three buffers). Bound: the chain of adds (FADD latency), not L2.
//       Rows 1..rb-1 are written as zeros;
//   fk_probe_bsearch       (P4, probe_mosaic.py:146 `probe_scalar_bsearch`):
//     kernel C's lookup, a lower-bound binary search in a sorted int32 table
//     held in shared memory. At most one block per SM (a grid-stride loop
//     past that), each staging the table once with one TMA bulk copy onto
//     an mbarrier (4-byte loads for the tail past a multiple of 16 bytes,
//     or for a table off 16 bytes) while it loads its first queries. Each
//     thread takes BS_PER queries (strided by the block, so every round of
//     loads is coalesced) and searches them in lockstep, branch-free, with
//     a fixed number of steps for the table's n: pos += t[pos + step - 1]
//     < v ? step : 0 for step = P/2 .. 1, P the power of two >= n + 1, the
//     entries past n a virtual +inf. The BS_PER dependent chains overlap.
//     A query past nq searches INT32_MIN, whose position is 0. The integer
//     sum of the positions is taken per block and added with one atomic
//     (integer addition, so the result does not depend on the order).
//     Bound: log2(P) dependent shared-memory loads per query, after one
//     table copy into the SM, and the launch;
//
//   fk_smem_chase_cycles   (no TPU counterpart: a measurement for P4's
//     bound): one thread walks a chain of dependent shared-memory loads
//     and reports the clock cycles a load takes.
//
// Every launch past 48 KB of dynamic shared memory asks for it through
// OptIn, which calls cudaFuncSetAttribute only when a launch needs more
// than was granted before on the device.

#include <atomic>
#include <climits>

#include "common.cuh"

namespace {

constexpr int DEFAULT_SMEM = 48 * 1024;  // granted without an opt-in
constexpr int MAX_DEVICES = 64;

// ---- TMA bulk copies into shared memory, completed on an mbarrier --------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread: make *bar a barrier of one arrival, armed for `bytes` of
// bulk copies. The other threads may wait on it after a block barrier.
__device__ __forceinline__ void bar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory by the copy engine, completing on *bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the barrier's first phase has completed: every byte landed.
// A copy that never completes traps after ~2^31 clock cycles (about a
// second) rather than hanging the card.
__device__ __forceinline__ void bar_wait_first(uint64_t* bar) {
  const long long start = clock64();
  unsigned done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 31)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(0u)
        : "memory");
  }
}

// The dynamic shared memory granted to one kernel so far, per device.
class OptIn {
 public:
  // Let `kernel` launch with `bytes` of dynamic shared memory on the
  // current device. A refusal is cleared from the runtime's error state,
  // returned, and leaves the grant as it was.
  template <typename K>
  cudaError_t grant(K kernel, int bytes) {
    if (bytes <= DEFAULT_SMEM) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::atomic<int>* mark = dev < MAX_DEVICES ? &granted_[dev] : nullptr;
    if (mark != nullptr && bytes <= mark->load(std::memory_order_relaxed))
      return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    if (mark != nullptr) {
      int seen = mark->load(std::memory_order_relaxed);
      while (seen < bytes && !mark->compare_exchange_weak(seen, bytes)) {
      }
    }
    return cudaSuccess;
  }

 private:
  std::atomic<int> granted_[MAX_DEVICES] = {};
};

OptIn scratch_opt_in, input_opt_in, fixed_opt_in, bsearch_opt_in;

// The SM count of the current device, read once per device.
int sm_count() {
  static std::atomic<int> counts[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = dev < MAX_DEVICES ? counts[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    if (dev < MAX_DEVICES) counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

constexpr int SCRATCH_THREADS = 1024;

__global__ void smem_scratch_kernel(int n, int32_t* __restrict__ out) {
  extern __shared__ int4 scratch4[];
  int32_t* scratch = reinterpret_cast<int32_t*>(scratch4);
  const int4 v = make_int4(n, n, n, n);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) scratch4[i] = v;
  for (int i = n / 4 * 4 + threadIdx.x; i < n; i += blockDim.x)
    scratch[i] = n;
  __syncthreads();
  if (threadIdx.x == 0) out[0] = scratch[n - 1];
}

constexpr int INPUT_THREADS = 1024;
constexpr int INPUT_DEPTH = 8;  // 16-byte loads in flight a thread

// Block step = blockIdx.x: its rb * hb int32 at x + step * rb * hb into
// shared memory (16-byte loads where `vec`, else 4-byte); then
// sums[step - first] (when >= 0) = the int32 sum of blk[i * hb + (i &
// 1023)], i < rb.
__global__ void __launch_bounds__(INPUT_THREADS)
    smem_input_kernel(const int32_t* __restrict__ x, int rb, int hb, int vec,
                      int32_t* __restrict__ sums, int first) {
  extern __shared__ int4 blk4[];
  int32_t* blk = reinterpret_cast<int32_t*>(blk4);
  const int n = rb * hb;
  const int32_t* src = x + static_cast<int64_t>(blockIdx.x) * n;
  const int n4 = vec ? n / 4 : 0;
  const int4* src4 = reinterpret_cast<const int4*>(src);
  for (int i0 = threadIdx.x; i0 < n4; i0 += INPUT_DEPTH * blockDim.x) {
    int4 v[INPUT_DEPTH];
#pragma unroll
    for (int j = 0; j < INPUT_DEPTH; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n4) v[j] = __ldg(src4 + i);
    }
#pragma unroll
    for (int j = 0; j < INPUT_DEPTH; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n4) blk4[i] = v[j];
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) blk[i] = src[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned acc = 0;
    for (int i = threadIdx.x; i < rb; i += 32)
      acc += static_cast<unsigned>(blk[i * hb + (i & 1023)]);
    acc = __reduce_add_sync(0xffffffffu, acc);
    const int slot = static_cast<int>(blockIdx.x) - first;
    if (threadIdx.x == 0 && slot >= 0) sums[slot] = static_cast<int32_t>(acc);
  }
}

// ---- P3 / P6 B, C: one block per output row -------------------------------

constexpr int ROW_THREADS = 1024;
constexpr int ROW_ROUNDS = 8;  // compaction rounds per chunk of hits
constexpr int ROW_CHUNK = ROW_THREADS * ROW_ROUNDS;  // hits per list

__global__ void __launch_bounds__(ROW_THREADS, 2)
    dyn_rows_bucketed_kernel(const float* __restrict__ q, int d,
                             const int32_t* __restrict__ idx,
                             const int32_t* __restrict__ row, int nh,
                             int src_dyn, int accumulate, int steps,
                             float* __restrict__ e) {
  __shared__ int32_t list[ROW_CHUNK];  // this row's sources, in hit order
  __shared__ int scratch[33];
  const int r = blockIdx.x;
  float* e_row = e + static_cast<int64_t>(r) * d;
  // every hit in one chunk: build the list once and walk it `steps` times
  const bool one_chunk = nh <= ROW_CHUNK;
  const int passes = one_chunk ? 1 : steps;
  const int walks = one_chunk ? steps : 1;
  for (int s = 0; s < passes; ++s) {
    for (int h0 = 0; h0 == 0 || h0 < nh; h0 += ROW_CHUNK) {
      // each thread's hits of the chunk: -1, or the source of a hit of row r
      int src[ROW_ROUNDS];
#pragma unroll
      for (int k = 0; k < ROW_ROUNDS; ++k) {
        const int i = h0 + k * ROW_THREADS + threadIdx.x;
        src[k] = i < nh ? row[i] : -1;
      }
#pragma unroll
      for (int k = 0; k < ROW_ROUNDS; ++k) {
        const int i = h0 + k * ROW_THREADS + threadIdx.x;
        src[k] = src[k] == r ? (src_dyn ? idx[i] : 0) : -1;
      }
      int n = 0;
#pragma unroll
      for (int k = 0; k < ROW_ROUNDS; ++k) {
        int count;
        const int pos = block_compact(src[k] >= 0, scratch, &count);
        if (pos >= 0) list[n + pos] = src[k];
        n += count;
      }
      __syncthreads();  // the list is complete
      const bool first = s == 0 && h0 == 0;
      if (first || n > 0) {
        for (int c = threadIdx.x; c < d; c += ROW_THREADS) {
          const float* qc = q + c;
          float acc = first ? 0.f : e_row[c];
          if (accumulate) {
            for (int w = 0; w < walks; ++w) {
#pragma unroll 8
              for (int j = 0; j < n; ++j)
                acc += qc[static_cast<int64_t>(list[j]) * d];
            }
          } else if (n > 0) {
            acc = qc[static_cast<int64_t>(list[n - 1]) * d];
          }
          e_row[c] = acc;
        }
      }
      __syncthreads();  // the list is rebuilt for the next chunk
    }
  }
}

// ---- P6 A: every hit into row 0 ---------------------------------------------

constexpr int FIX_COLS = 32;      // columns a block: one 128-byte q line
constexpr int FIX_THREADS = 256;  // warp 0 sums, warps 1-7 copy
constexpr int FIX_COPIERS = FIX_THREADS - 32;
constexpr int FIX_BATCH = 256;    // hits per staged batch of q strips
constexpr int FIX_STAGES = 3;     // strip buffers in flight
constexpr int FIX_SRC = 4096;     // hit sources held in shared memory
constexpr int FIX_SMEM = (FIX_STAGES * FIX_BATCH * FIX_COLS + FIX_SRC) *
                         static_cast<int>(sizeof(float));
constexpr int FIX_REGS = 32;      // strip values a summing lane holds

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// vec: q rows start on 16-byte boundaries (d % 4 == 0, q aligned), so the
// strips are copied in 16-byte pieces, else in single floats. Batch b sits
// in buffer b % 3: while warp 0 sums batch b, warps 1-7 start batch b + 2
// into the buffer batch b - 1 left, and batch b + 1 is landing.
__global__ void __launch_bounds__(FIX_THREADS)
    dyn_rows_fixed_kernel(const float* __restrict__ q, int d,
                          const int32_t* __restrict__ idx, int nh, int rb,
                          int src_dyn, int accumulate, int steps, int vec,
                          float* __restrict__ e) {
  extern __shared__ int4 smem4[];
  float* strips = reinterpret_cast<float*>(smem4);  // [3][FIX_BATCH][FIX_COLS]
  int32_t* src =
      reinterpret_cast<int32_t*>(strips + FIX_STAGES * FIX_BATCH * FIX_COLS);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * FIX_COLS;
  const bool live = c0 + lane < d;
  if (live) {
    for (int r = 1 + warp; r < rb; r += FIX_THREADS / 32)
      e[static_cast<int64_t>(r) * d + c0 + lane] = 0.f;
  }
  const int shift = vec ? 3 : 5;  // log2 of the copies a strip takes
  const int per = vec ? 4 : 1;    // floats a copy moves
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    for (int h0 = 0; h0 < nh; h0 += FIX_SRC) {
      const int nc = min(FIX_SRC, nh - h0);
      __syncthreads();  // the last chunk's sources and strips are spent
      for (int i = threadIdx.x; i < nc; i += FIX_THREADS) {
        if (src_dyn) {
          cp_async<4>(src + i, idx + h0 + i);
        } else {
          src[i] = 0;
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int nb = (nc + FIX_BATCH - 1) / FIX_BATCH;
      // a copying thread's strips of batch b, as one cp.async group (an
      // empty one past the last batch, so the groups count batches)
      auto stage = [&](int b) {
        if (b < nb) {
          float* buf = strips + (b % FIX_STAGES) * FIX_BATCH * FIX_COLS;
          const int j_end = min(FIX_BATCH, nc - b * FIX_BATCH);
          for (int k = threadIdx.x - 32; k < j_end << shift;
               k += FIX_COPIERS) {
            const int j = k >> shift;
            const int col = (k - (j << shift)) * per;
            if (c0 + col < d) {
              const float* from =
                  q + static_cast<int64_t>(src[b * FIX_BATCH + j]) * d + c0 +
                  col;
              if (vec) {
                cp_async<16>(buf + j * FIX_COLS + col, from);
              } else {
                cp_async<4>(buf + j * FIX_COLS + col, from);
              }
            }
          }
        }
        cp_async_commit();
      };
      if (warp > 0) {
        stage(0);
        stage(1);
      }
      for (int b = 0; b < nb; ++b) {
        if (warp > 0) cp_async_wait<1>();  // batch b has landed
        __syncthreads();
        if (warp > 0) {
          stage(b + 2);
        } else if (live) {
          const float* buf =
              strips + (b % FIX_STAGES) * FIX_BATCH * FIX_COLS + lane;
          const int j_end = min(FIX_BATCH, nc - b * FIX_BATCH);
          if (accumulate) {
            // loads run ahead of the chain of adds, which keeps hit order
            int j = 0;
            for (; j + FIX_REGS <= j_end; j += FIX_REGS) {
              float v[FIX_REGS];
#pragma unroll
              for (int k = 0; k < FIX_REGS; ++k) v[k] = buf[(j + k) * FIX_COLS];
#pragma unroll
              for (int k = 0; k < FIX_REGS; ++k) acc += v[k];
            }
            for (; j < j_end; ++j) acc += buf[j * FIX_COLS];
          } else {
            acc = buf[(j_end - 1) * FIX_COLS];
          }
        }
        __syncthreads();  // buffer b % 3 is free for batch b + 3
      }
    }
  }
  if (warp == 0 && live) e[c0 + lane] = acc;
}

constexpr int BS_THREADS = 128;  // probes.BSEARCH_THREADS
constexpr int BS_PER = 4;        // queries a thread, in lockstep (BSEARCH_PER)
constexpr int BS_GROUP = BS_THREADS * BS_PER;  // queries a block a round

// Queries g + j * BS_THREADS + threadIdx.x, j < BS_PER, into v; INT32_MIN
// past nq (its lower bound is 0).
__device__ __forceinline__ void load_queries(const int32_t* __restrict__ q,
                                             int64_t nq, int64_t g,
                                             int32_t (&v)[BS_PER]) {
#pragma unroll
  for (int j = 0; j < BS_PER; ++j) {
    const int64_t i = g + j * BS_THREADS + threadIdx.x;
    v[j] = i < nq ? __ldg(q + i) : INT_MIN;
  }
}

// The table's first bulk_n entries (a multiple of 4; 0 when the table is
// off 16 bytes) come by one bulk copy, the rest by 4-byte loads. top =
// P / 2, P the power of two >= n + 1.
__global__ void __launch_bounds__(BS_THREADS)
    bsearch_kernel(const int32_t* __restrict__ table, int n, int bulk_n,
                   int top, const int32_t* __restrict__ queries, int nq,
                   int32_t* __restrict__ out) {
  extern __shared__ int4 t4[];
  __shared__ uint64_t bar;
  __shared__ int acc;
  const int32_t* t = reinterpret_cast<const int32_t*>(t4);
  if (threadIdx.x == 0 && bulk_n > 0) {
    bar_arm(&bar, bulk_n * 4u);
    bulk_load(t4, table, bulk_n * 4u, &bar);
  }
  for (int i = bulk_n + threadIdx.x; i < n; i += BS_THREADS)
    reinterpret_cast<int32_t*>(t4)[i] = table[i];
  int64_t g = static_cast<int64_t>(blockIdx.x) * BS_GROUP;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * BS_GROUP;
  int32_t v[BS_PER];
  load_queries(queries, nq, g, v);  // in flight while the table lands
  __syncthreads();  // the tail is stored, the barrier initialised
  if (bulk_n > 0) bar_wait_first(&bar);
  unsigned total = 0;
  for (; g < nq; g += stride) {
    int pos[BS_PER];
#pragma unroll
    for (int j = 0; j < BS_PER; ++j) pos[j] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < BS_PER; ++j) {
        const int i = pos[j] + step - 1;
        pos[j] += (i < n) & (t[min(i, n - 1)] < v[j]) ? step : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < BS_PER; ++j) total += pos[j];
    load_queries(queries, nq, g + stride, v);
  }
  const int sum = block_sum(static_cast<int>(total), &acc);
  if (threadIdx.x == 0) atomicAdd(out, sum);
}

// One thread: `steps` dependent shared-memory loads, each entry holding
// the shared address of the next (a stride of 97 entries around 1,024),
// as volatile asm so they stay between the clock reads; cycles[0] = clock
// cycles a load, cycles[1] = where the chain ended.
constexpr int CHASE_N = 1024;

__global__ void smem_chase_kernel(int steps, int64_t* __restrict__ cycles) {
  __shared__ unsigned chain[CHASE_N];
  for (int i = 0; i < CHASE_N; ++i)
    chain[i] = smem_u32(chain + (i + 97) % CHASE_N);
  unsigned at = smem_u32(chain);
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s)
    asm volatile("ld.shared.u32 %0, [%0];\n" : "+r"(at) : : "memory");
  const long long t1 = clock64();
  cycles[0] = (t1 - t0) / steps;
  cycles[1] = at;
}

}  // namespace

extern "C" int fk_probe_smem_scratch(int n, int32_t* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = n * static_cast<int>(sizeof(int32_t));
  cudaError_t err = scratch_opt_in.grant(smem_scratch_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (n / 4 + 31) / 32 * 32;
  if (threads > SCRATCH_THREADS) threads = SCRATCH_THREADS;
  if (threads < 32) threads = 32;
  smem_scratch_kernel<<<1, threads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(n, out);
  return static_cast<int>(cudaGetLastError());
}

// x holds `steps` blocks of (rb, hb) int32, hb >= min(rb, 1024); sums
// (n_sums,) receives the last n_sums steps' sums.
extern "C" int fk_probe_smem_input(const int32_t* x, int steps, int rb,
                                   int hb, int32_t* sums, int n_sums,
                                   void* stream) {
  if (steps <= 0 || rb <= 0 || hb < (rb < 1024 ? rb : 1024) || n_sums <= 0 ||
      n_sums > steps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = rb * hb * static_cast<int>(sizeof(int32_t));
  const cudaError_t err = input_opt_in.grant(smem_input_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && bytes % 16 == 0 ? 1 : 0;
  smem_input_kernel<<<steps, INPUT_THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(x, rb, hb, vec,
                                                           sums,
                                                           steps - n_sums);
  return static_cast<int>(cudaGetLastError());
}

// dst_dyn selects the kernel: one block per output row, or column tiles of
// the fixed row 0. q is (any rows, d), idx and row (nh,), e (rb, d).
extern "C" int fk_probe_dyn_rows(const float* q, int d, const int32_t* idx,
                                 const int32_t* row, int nh, int rb,
                                 int src_dyn, int dst_dyn, int accumulate,
                                 int steps, float* e, void* stream) {
  if (d <= 0 || rb <= 0 || nh < 0 || steps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dst_dyn) {  // static shared memory only
    dyn_rows_bucketed_kernel<<<rb, ROW_THREADS, 0, st>>>(
        q, d, idx, row, nh, src_dyn, accumulate, steps, e);
  } else {
    const cudaError_t err = fixed_opt_in.grant(dyn_rows_fixed_kernel,
                                               FIX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vec =
        d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 ? 1 : 0;
    dyn_rows_fixed_kernel<<<(d + FIX_COLS - 1) / FIX_COLS, FIX_THREADS,
                            FIX_SMEM, st>>>(q, d, idx, nh, rb, src_dyn,
                                            accumulate, steps, vec, e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fk_probe_bsearch(const int32_t* table, int n,
                                const int32_t* queries, int nq, int32_t* out,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every position in an empty table is 0
  if (nq <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int bytes = n * static_cast<int>(sizeof(int32_t));
  err = bsearch_opt_in.grant(bsearch_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int top = 1;
  while (top <= n / 2) top <<= 1;  // P / 2, P the power of two >= n + 1
  const int bulk_n = reinterpret_cast<uintptr_t>(table) % 16 == 0 ? n & ~3 : 0;
  const int sms = sm_count();
  const int64_t groups = (static_cast<int64_t>(nq) + BS_GROUP - 1) / BS_GROUP;
  const int blocks = static_cast<int>(groups < sms ? groups : sms);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bsearch_kernel<<<blocks, BS_THREADS, bytes, st>>>(table, n, bulk_n, top,
                                                    queries, nq, out);
  return static_cast<int>(cudaGetLastError());
}

// Clock cycles of one dependent shared-memory load (cycles[0]; cycles[1]
// the chain's end), over `steps` loads by one thread.
extern "C" int fk_smem_chase_cycles(int steps, int64_t* cycles,
                                    void* stream) {
  if (steps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  smem_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(steps,
                                                                    cycles);
  return static_cast<int>(cudaGetLastError());
}
