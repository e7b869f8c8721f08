// K9: the IVF k-means's segment sum (knn/ivf.py _segment_sum), with its
// own bucketing of the rows by cluster; and K11, the IVF member and probe
// buckets and K6's work list (knn/ivf.py bucket_clusters), a bucketing in
// one cooperative launch.
//
// Computes what the JAX package's _kmeans does with jax.ops.segment_sum
// (fedrann_tpu/knn/ivf.py:83, in _kmeans :61; an XLA scatter-add, no
// pl.pallas_call): sums[c] = the float32 sum of the rows assigned to
// cluster c. The order is fixed: each cluster's rows are added in row
// order, one float32 add at a time, from +0.0 (or from the sums it is
// given, so that rows streamed in chunks add as one pass would), bfloat16
// rows widened to float32 first. That is bitwise jax.ops.segment_sum on a
// CPU, and two launches give the same bits.
//
// One C entry, fk_ivf_segment_sum, takes the int32 assignments and the
// rows and launches three bucketing kernels and the sum kernel on the
// stream it is given; no torch op runs between them. The bucketing is a
// stable counting sort of the assignments into (order, bounds): order the
// row ids sorted stably by cluster, cluster c's rows order[bounds[c] :
// bounds[c + 1]]. A stable sort is unique, so both equal knn/ivf.py
// _segments' (a torch stable sort and a searchsorted) value for value.
//   1. seg_count_kernel: a warp a tile of tile_rows consecutive rows counts
//      its rows of each cluster, one atomic add a row (the ids of BATCH
//      steps of 32 rows load at once), in shared memory while C ints a
//      warp fit in 48 KB (C <= 12,288), else straight into the (tile,
//      cluster) counts in device memory, zeroed first.
//   2. seg_scan_kernel: a block a run of 32 clusters, its 32 warps over the
//      tiles (at most 1,024, 32 a warp in registers), turns each cluster's
//      counts over the tiles
//      into exclusive prefixes and its total into the cluster's size; the
//      block that finishes last (a counter the count kernel zeroes) turns
//      the sizes into the bounds and orders the clusters longest first (by
//      the bit length of their size) for the sum kernel.
//   3. seg_scatter_kernel: each tile's warp walks its rows again in order,
//      32 a step, and writes each row id at its cluster's bound plus the
//      tile's prefix plus the rows of that cluster the tile has placed
//      before it (a cursor a cluster, in shared memory or the counts),
//      plus its rank among the step's equal ids (__match_any_sync): a
//      stable order.
//   4. seg_sum_ring_kernel: a warp a unit of (cluster, 32 lanes x 16 bytes
//      of columns: 128 float32 or 256 bfloat16), the units of the largest
//      clusters first. A lane copies its 16 bytes of each member row into
//      its own slots of a per-warp ring in shared memory by cp.async, RING
//      rows ahead, and adds them from there in member order (__fadd_rn).
//      The member ids come in 32 at a time, one coalesced load a batch
//      ahead, and reach the lanes by __shfl_sync. Rows whose d * itemsize
//      is not a multiple of 16, or whose base is not 16-byte aligned, take
//      seg_sum_scalar_kernel (the same order, loads one element at a time).
//
// Bound on the card: the bytes the function must move, the rows read once
// (N * d * itemsize), the N int32 assignments read and the sums written
// (C * d * 4; read too when accumulating): 540.0 MB at N = 262,144, d =
// 512, C = 1,024 float32, 0.1612 ms at 3.35 TB/s (bfloat16 rows: 0.0811
// ms). The sorted ids, bounds and counts are the function's own scratch,
// not counted.
//
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 12
// and tools/k8_k9_variants.py): at 11b's rows the sum kernel reads ~86%
// (float32) / ~80% (bfloat16) of that bound, and the bucketing adds ~19
// us of device time in latency-bound steps of 32 rows (__match_any_sync
// costs more the more distinct ids a step holds); at phase 4's 15,000 rows
// the call (0.035-0.06 ms as the host's speed varies) is bound by its
// host path (the wrapper, the scratch and four launches) over ~20 us of
// device time. The longest cluster's in-order walk is no limit at either
// (11b's k-means leaves at most 419 rows a cluster): the ring keeps RING
// of its rows in flight a lane, and the longest-first order starts it at
// the launch.
//
// K11 (bucket_kernel, entry fk_ivf_bucket) replaces the JAX package's
// _member_table (fedrann_tpu/knn/ivf.py:117) and _probe_tables (:170): a
// stable jnp.argsort of the cluster ids, then a scatter into a (C, width)
// table padded with a sentinel (XLA, no pl.pallas_call). XLA needs the
// static width; K6 does not (it walks each cluster's true count), so K11
// writes the bucket form: the (C + 1) bounds and, in bucket order, each
// entry r as r / div (vals) and, on the probe side, r % div (slots);
// cluster c's are vals[bounds[c] : bounds[c + 1]] in entry order, the
// same stable order, and expanded row by row they are JAX's table up to
// each count. There is no width, no pad, no host copy and no counter
// carried between launches. The probe side also takes the member side's
// bounds and writes K6's work list: each probed cluster's ceil(q / 128)
// units (first member offset, first query offset, slots, members), the
// clusters of the longest member counts (by bit length, as K9's schedule)
// first, and the unit count in device memory; K6 launches a grid the host
// bounds at ceil(n / 128) + C without reading it. One launch, a
// persistent grid of the blocks the card holds at once (asked of
// cudaOccupancyMaxActiveBlocksPerMultiprocessor once, at least
// BK_MIN_BLOCKS an SM), its phases apart by cooperative_groups grid
// barriers (bucket_kernel says what each does). A tile's stable ranks come
// from one ballot a bit of the ids a step of 32 (the lanes of a step with
// the same cluster), not __match_any_sync, and a block's warps each walk
// a consecutive part of its tile with counts of their own in shared memory
// (past SMEM_HIST clusters a warp is a tile, its counts in device memory,
// zeroed by the launch behind a barrier). The plan sizes the tiles for
// about BK_RUN entries of each cluster (at least BK_MIN_TILES tiles where
// the entries allow): a cluster's entries of a tile land side by side, so
// its scattered stores share sectors. Its bound is bytes: the n ids
// read, vals (and slots) written, the bounds written (the member side's
// read) and the units written: 7.6 us at 11b's probe lists (2,097,152
// ids), 1.3 us at its member lists, at 3.35 TB/s. Each entry's vals and
// slots are single scattered 4-byte stores (a step's 32 entries fall in
// as many clusters on the probe side), so the scatter, not the bytes,
// sets its time (chip_smoke.py phase 12 logs it beside torch.sort).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_WARPS = 8;      // tile warps a block (at most)
constexpr int SMEM_HIST = 12288;   // clusters a warp counts in shared memory
constexpr int BATCH = 8;           // steps of 32 rows whose ids load at once
constexpr int MAX_TILES = 1024;    // tiles a bucketing (knn/ivf.py)
constexpr int SCAN_WARPS = 32;     // warps of a scan block, over the tiles
constexpr int SCAN_PER = MAX_TILES / SCAN_WARPS;  // tiles a scan warp holds
constexpr int SUM_WARPS = 4;       // units a block of the sum kernels
constexpr int RING = 16;           // member rows in flight a lane
static_assert(RING <= 32, "a member batch covers the ring");
static_assert(SUM_WARPS * RING * 512 <= 48 * 1024, "static shared memory");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into dst, or nothing when !live (the group still
// counts)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  if (live) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(smem_u32(dst)), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this lane's copies of all but the last RING - 1 groups have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
}

// The cluster of row `row` of a tile ending at `end`, or -1 past the end
// or out of [0, C) (such a row belongs to no cluster).
__device__ __forceinline__ int cluster_of(const int32_t* __restrict__ a,
                                          int64_t row, int64_t end, int c_n) {
  const int c = row < end ? __ldg(a + row) : -1;
  return static_cast<unsigned>(c) < static_cast<unsigned>(c_n) ? c : -1;
}

// Per tile (a warp each) the rows of each cluster: counts[t * C + c], one
// atomic add a row (the order of adds changes no count). Block 0 also
// zeroes the scan's counter of finished blocks.
__global__ void seg_count_kernel(const int32_t* __restrict__ a, int64_t n,
                                 int c_n, int64_t tile_rows, int n_tiles,
                                 bool smem, int32_t* __restrict__ counts,
                                 int32_t* __restrict__ done) {
  extern __shared__ int32_t hist_s[];
  if (blockIdx.x == 0 && threadIdx.x == 0) *done = 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= n_tiles) return;
  int32_t* hist = smem ? hist_s + warp * c_n
                       : counts + static_cast<int64_t>(t) * c_n;
  if (smem) {
    for (int i = lane; i < c_n; i += 32) hist[i] = 0;
    __syncwarp();
  }
  const int64_t r0 = t * tile_rows;
  const int64_t end = min(n, r0 + tile_rows);
  for (int64_t r = r0; r < end; r += 32 * BATCH) {
    int cs[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      cs[k] = cluster_of(a, r + 32 * k + lane, end, c_n);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (cs[k] >= 0) atomicAdd(hist + cs[k], 1);
    }
  }
  if (smem) {
    __syncwarp();
    int32_t* dst = counts + static_cast<int64_t>(t) * c_n;
    for (int i = lane; i < c_n; i += 32) dst[i] = hist[i];
  }
}

// Exclusive prefix of v over a block of WARPS warps, its total in *total;
// `warp_sums` a __shared__ int[WARPS + 1].
template <int WARPS>
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int x = warp_sums[w];
      warp_sums[w] = run;
      run += x;
    }
    warp_sums[WARPS] = run;
  }
  __syncthreads();
  *total = warp_sums[WARPS];
  const int out = warp_sums[warp] + incl - v;
  __syncthreads();  // warp_sums is free for the next scan
  return out;
}

// A block a run of 32 clusters, its warps over the tiles: counts[t * C +
// c] -> the rows of cluster c in tiles before t, and the cluster's size
// into bounds[c]. The block that finishes last then turns the sizes into
// the bounds: bounds[0 .. C] the exclusive prefix (bounds[C] the total),
// and sched the clusters by the bit length of their size, longest first
// (within a length in no fixed order: the schedule changes no sum).
__global__ void __launch_bounds__(SCAN_WARPS * 32)
    seg_scan_kernel(int32_t* __restrict__ counts, int c_n, int n_tiles,
                    int32_t* __restrict__ bounds,
                    int32_t* __restrict__ sched, int32_t* done) {
  __shared__ int part[SCAN_WARPS][32];
  __shared__ int warp_sums[SCAN_WARPS + 1];
  __shared__ int lengths[33];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool live = c < c_n;
  // warp w holds tiles w * SCAN_PER .. + SCAN_PER - 1 in registers
  int v[SCAN_PER];
  int own = 0;
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    const int t = warp * SCAN_PER + k;
    v[k] = live && t < n_tiles ? counts[static_cast<int64_t>(t) * c_n + c]
                               : 0;
    own += v[k];
  }
  part[warp][lane] = own;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    const int t = warp * SCAN_PER + k;
    if (live && t < n_tiles) counts[static_cast<int64_t>(t) * c_n + c] = run;
    run += v[k];
  }
  if (live && warp == SCAN_WARPS - 1) bounds[c] = run;
  // the last block to finish scans the sizes
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int spread = (c_n + SCAN_WARPS * 32 - 1) / (SCAN_WARPS * 32);
  const int lo = min(c_n, static_cast<int>(threadIdx.x) * spread);
  const int hi = min(c_n, lo + spread);
  if (threadIdx.x < 33) lengths[threadIdx.x] = 0;
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += __ldcg(bounds + i);
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    atomicAdd(&lengths[32 - __clz(__ldcg(bounds + i))], 1);
  }
  int total;
  int at = block_scan<SCAN_WARPS>(mine, warp_sums, &total);
  if (threadIdx.x == 0) {  // longest first: each length's first slot
    int slot = 0;
    for (int b = 32; b >= 0; --b) {
      const int k = lengths[b];
      lengths[b] = slot;
      slot += k;
    }
  }
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const int size = __ldcg(bounds + i);
    sched[atomicAdd(&lengths[32 - __clz(size)], 1)] = i;
    bounds[i] = at;
    at += size;
  }
  if (threadIdx.x == 0) bounds[c_n] = total;
}

// Walks tile t's rows in row order, 32 a step (BATCH steps' ids loaded at
// once), and calls place(row, c, at) for each row of a cluster c, at its
// cursor: cursor[c] plus the rows of c placed before it in the tile (the
// cursor moves on by the step's rows of c at once, and a row's rank among
// the step's equal ids, by __match_any_sync, comes on top): a stable
// order.
template <class Place>
__device__ __forceinline__ void walk_tile(const int32_t* __restrict__ a,
                                          int64_t n, int c_n,
                                          int64_t tile_rows, int t,
                                          int32_t* cursor, Place place) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t r0 = t * tile_rows;
  const int64_t end = min(n, r0 + tile_rows);
  for (int64_t r = r0; r < end; r += 32 * BATCH) {
    int cs[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      cs[k] = cluster_of(a, r + 32 * k + lane, end, c_n);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int c = cs[k];
      const unsigned peers = __match_any_sync(FULL, c);
      const int first = __ffs(peers) - 1;
      int at = 0;
      if (c >= 0 && lane == first) at = atomicAdd(cursor + c, __popc(peers));
      at = __shfl_sync(FULL, at, first);
      if (c >= 0) place(r + 32 * k + lane, c, at + __popc(peers & below));
    }
  }
}

// Per tile (a warp each) its rows' ids into order, stably by cluster.
__global__ void seg_scatter_kernel(const int32_t* __restrict__ a, int64_t n,
                                   int c_n, int64_t tile_rows, int n_tiles,
                                   bool smem, int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ bounds,
                                   int32_t* __restrict__ order) {
  extern __shared__ int32_t cursor_s[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= n_tiles) return;
  int32_t* tile = counts + static_cast<int64_t>(t) * c_n;
  // the cursor of cluster c: where the tile's next row of c goes, less
  // bounds[c] in device memory
  int32_t* cursor = smem ? cursor_s + warp * c_n : tile;
  if (smem) {
    for (int i = lane; i < c_n; i += 32) cursor[i] = bounds[i] + tile[i];
    __syncwarp();
  }
  walk_tile(a, n, c_n, tile_rows, t, cursor,
            [&](int64_t row, int c, int at) {
              order[smem ? at : at + bounds[c]] = static_cast<int32_t>(row);
            });
}

// K11: the IVF member and probe buckets, and K6's work list, in one
// cooperative launch (bucket_kernel, entry fk_ivf_bucket).

constexpr int BK_WARPS = 8;                    // warps of a K11 block
constexpr int BK_THREADS = BK_WARPS * 32;
constexpr int BK_MIN_BLOCKS = 4;               // resident an SM, at least
constexpr int BK_MIN_ROWS = 256;               // entries a walking warp takes
constexpr int BK_RUN = 16;                     // a cluster's entries a tile
constexpr int BK_MIN_TILES = 128;              // tiles, where entries allow
constexpr int BK_CLASSES = 33;                 // bit lengths of a count: 0..32
constexpr int BK_MAX_BLOCKS = 2048;            // block sums scratch keeps
constexpr int BK_EXTRA = BK_MAX_BLOCKS + 2 * BK_CLASSES;  // scratch past counts
constexpr int K6_UNIT_ROWS = 128;              // query slots a K6 unit (BM)

struct BucketArgs {
  const int32_t* a;        // (n,) cluster ids
  int64_t n;
  int c_n, nbits;          // clusters; bits of the largest id
  int div;                 // an entry r goes in as r / div (and r % div)
  int walkers;             // warps that walk a block's tile (counts in smem)
  bool smem;               // each warp's counts in shared memory
  int64_t wt;              // entries a walking warp takes
  int tiles;               // rows of counts: block tiles, or warp tiles
  int32_t* counts;         // (tiles, C)
  int32_t* block_sums;     // (gridDim.x,) the sizes of each block's range
  int32_t* cls;            // units of each class, then each class's cursor
  const int32_t* member_bounds;  // (C + 1,) the member side's, or null
  int32_t* vals;           // (n,) r / div in bucket order
  int32_t* slots;          // (n,) r % div, or null
  int32_t* bounds;         // (C + 1,)
  int4* units;             // K6's work list, with member_bounds
  int32_t* n_units;        // (1,) its length
};

// Walks entries [r0, end) in order, 32 a step (BATCH steps' ids loaded at
// once), and calls visit(row, c, peers, below) on every lane with its
// entry's cluster c (-1 for none: past the end or an id outside [0, C)):
// peers the lanes of the step whose entry has the same cluster, from one
// ballot a bit of the ids (nbits of them) and one on validity; below the
// lanes under this one. The visit orders the step's entries of a cluster
// by lane, so the walk is stable. Every lane calls visit.
template <class Visit>
__device__ __forceinline__ void walk_ids(const int32_t* __restrict__ a,
                                         int64_t r0, int64_t end, int c_n,
                                         int nbits, Visit visit) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t r = r0; r < end; r += 32 * BATCH) {
    int cs[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      cs[k] = cluster_of(a, r + 32 * k + lane, end, c_n);
    }
    // the BATCH steps' ballots are independent: taken bit by bit across
    // the steps, so they overlap
    unsigned peers[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) peers[k] = __ballot_sync(FULL, cs[k] >= 0);
    for (int b = 0; b < nbits; ++b) {
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const bool bit = (cs[k] >> b) & 1;
        const unsigned x = __ballot_sync(FULL, bit);
        peers[k] &= bit ? x : ~x;
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (r + 32 * k >= end) break;
      visit(r + 32 * k + lane, cs[k], peers[k], below);
    }
  }
}

// K11, a persistent grid of co-resident blocks (a cooperative launch),
// its phases apart by grid-wide barriers:
//   0. (counts in device memory only) zero the (warp tile, cluster)
//      counts; every launch: block 0 zeroes the class totals and cursors.
//   1. Count: each walking warp counts its tile's entries of each cluster
//      (the leader of a step's peers adds their number to its own row, in
//      shared memory, or in device memory past SMEM_HIST clusters); a
//      block's rows in shared memory are summed into its tile's row.
//   2. Scan: a warp a cluster (the clusters cut into one contiguous range
//      a block) turns its counts over the tiles into exclusive prefixes
//      (a run of consecutive tiles a lane, read twice: a sum, then the
//      prefixes) and puts its size in bounds[c]; each
//      block sums its range's sizes; on the probe side each probed
//      cluster's ceil(size / 128) units are added to its class (the bit
//      length of its member count).
//   3. Bounds and units: each block adds the sums of the ranges before it
//      to its range's prefix and writes the bounds; on the probe side each
//      probed cluster takes its units at its class's start (the longer
//      classes first, as K9's schedule orders clusters) plus a cursor of
//      the class (an atomic: the order within a class is free, as no unit
//      writes another's lists), the unit count last.
//   4. Scatter: each walking warp walks its tile again with a cursor a
//      cluster (the cluster's bound, the tile's prefix and, in shared
//      memory, the prefix over the block's warps before it), the leader
//      of a step's peers moving it by their number, each entry written at
//      the cursor plus its rank among its peers: a stable order.
__global__ void __launch_bounds__(BK_THREADS, BK_MIN_BLOCKS)
    bucket_kernel(const BucketArgs k) {
  extern __shared__ int32_t hist_s[];  // (walkers, C) with smem
  __shared__ int warp_sums[BK_WARPS + 1];
  __shared__ int cls_s[BK_CLASSES];
  __shared__ int range_s;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c_n = k.c_n;
  const bool pow2 = (k.div & (k.div - 1)) == 0;
  const int shift = __ffs(k.div) - 1;
  const bool probe = k.member_bounds != nullptr;
  // the tile a warp walks (a block's with smem, its own without), its
  // counts row and its entries
  const int64_t tile = k.smem ? blockIdx.x
                              : static_cast<int64_t>(blockIdx.x) * BK_WARPS
                                    + warp;
  const bool walks = tile < k.tiles && (!k.smem || warp < k.walkers);
  const int64_t r0 = (k.smem ? tile * k.walkers + warp : tile) * k.wt;
  const int64_t end = r0 + k.wt < k.n ? r0 + k.wt : k.n;
  int32_t* row = k.smem ? hist_s + warp * c_n : k.counts + tile * c_n;

  // 0.
  if (blockIdx.x == 0 && threadIdx.x < 2 * BK_CLASSES) {
    k.cls[threadIdx.x] = 0;
  }
  if (!k.smem) {
    const int64_t cells = static_cast<int64_t>(k.tiles) * c_n;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * BK_THREADS
                     + threadIdx.x;
         i < cells; i += static_cast<int64_t>(gridDim.x) * BK_THREADS) {
      k.counts[i] = 0;
    }
    grid.sync();
  }
  // 1.
  if (k.smem && blockIdx.x < k.tiles) {
    for (int i = threadIdx.x; i < k.walkers * c_n; i += BK_THREADS) {
      hist_s[i] = 0;
    }
    __syncthreads();
  }
  if (walks) {
    walk_ids(k.a, r0, end, c_n, k.nbits,
             [&](int64_t, int c, unsigned peers, unsigned below) {
               if (c >= 0 && (peers & below) == 0) row[c] += __popc(peers);
               __syncwarp();
             });
  }
  if (k.smem && blockIdx.x < k.tiles) {
    __syncthreads();
    int32_t* dst = k.counts + static_cast<int64_t>(blockIdx.x) * c_n;
    for (int c = threadIdx.x; c < c_n; c += BK_THREADS) {
      int s = 0;
      for (int w = 0; w < k.walkers; ++w) s += hist_s[w * c_n + c];
      dst[c] = s;
    }
  }
  grid.sync();
  // 2.
  const int span = (c_n + gridDim.x - 1) / gridDim.x;
  const int lo = min(c_n, static_cast<int>(blockIdx.x) * span);
  const int hi = min(c_n, lo + span);
  if (threadIdx.x < BK_CLASSES) cls_s[threadIdx.x] = 0;
  if (threadIdx.x == 0) range_s = 0;
  __syncthreads();
  const int per = (k.tiles + 31) / 32;  // tiles a lane, consecutive
  const int t0 = min(k.tiles, lane * per), t1 = min(k.tiles, t0 + per);
  for (int c = lo + warp; c < hi; c += BK_WARPS) {
    int32_t* col = k.counts + c;
    int own = 0;
#pragma unroll 16
    for (int t = t0; t < t1; ++t) own += col[static_cast<int64_t>(t) * c_n];
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += x;
    }
    int run = incl - own;
#pragma unroll 16
    for (int t = t0; t < t1; ++t) {
      const int x = col[static_cast<int64_t>(t) * c_n];
      col[static_cast<int64_t>(t) * c_n] = run;
      run += x;
    }
    const int size = __shfl_sync(FULL, incl, 31);
    if (lane == 0) {
      k.bounds[c] = size;
      atomicAdd(&range_s, size);
      if (probe && size > 0) {
        const int m = k.member_bounds[c + 1] - k.member_bounds[c];
        atomicAdd(&cls_s[32 - __clz(m)],
                  (size + K6_UNIT_ROWS - 1) / K6_UNIT_ROWS);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) k.block_sums[blockIdx.x] = range_s;
  if (probe && threadIdx.x < BK_CLASSES && cls_s[threadIdx.x] != 0) {
    atomicAdd(k.cls + threadIdx.x, cls_s[threadIdx.x]);
  }
  grid.sync();
  // 3.
  int before = 0;
  for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x);
       i += BK_THREADS) {
    before += k.block_sums[i];
  }
  int carry;
  block_scan<BK_WARPS>(before, warp_sums, &carry);
  // each class's first unit, longest first (the totals read at once)
  if (probe && threadIdx.x < BK_CLASSES) {
    cls_s[threadIdx.x] = k.cls[threadIdx.x];
  }
  __syncthreads();
  if (probe && threadIdx.x == 0) {
    int at = 0;
    for (int b = BK_CLASSES - 1; b >= 0; --b) {
      const int x = cls_s[b];
      cls_s[b] = at;
      at += x;
    }
    if (blockIdx.x == 0) *k.n_units = at;
  }
  __syncthreads();
  for (int c0 = lo; c0 < hi; c0 += BK_THREADS) {
    const int c = c0 + threadIdx.x;
    const int size = c < hi ? k.bounds[c] : 0;
    int total;
    const int at = carry + block_scan<BK_WARPS>(size, warp_sums, &total);
    if (c < hi) {
      k.bounds[c] = at;
      if (probe && size > 0) {
        const int m0 = k.member_bounds[c];
        const int m = k.member_bounds[c + 1] - m0;
        const int nu = (size + K6_UNIT_ROWS - 1) / K6_UNIT_ROWS;
        const int u0 = cls_s[32 - __clz(m)]
                       + atomicAdd(k.cls + BK_CLASSES + 32 - __clz(m), nu);
        for (int j = 0; j < nu; ++j) {
          k.units[u0 + j] = make_int4(m0, at + j * K6_UNIT_ROWS,
                                      min(K6_UNIT_ROWS,
                                          size - j * K6_UNIT_ROWS), m);
        }
      }
    }
    carry += total;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) k.bounds[c_n] = carry;
  grid.sync();
  // 4.
  if (k.smem && blockIdx.x < k.tiles) {
    const int32_t* prefix =
        k.counts + static_cast<int64_t>(blockIdx.x) * c_n;
    for (int c = threadIdx.x; c < c_n; c += BK_THREADS) {
      int run = k.bounds[c] + prefix[c];
      for (int w = 0; w < k.walkers; ++w) {
        const int x = hist_s[w * c_n + c];
        hist_s[w * c_n + c] = run;
        run += x;
      }
    }
    __syncthreads();
  }
  if (walks) {
    walk_ids(k.a, r0, end, c_n, k.nbits,
             [&](int64_t r, int c, unsigned peers, unsigned below) {
               const bool lead = c >= 0 && (peers & below) == 0;
               int at = 0;
               if (lead) {
                 at = row[c];
                 row[c] = at + __popc(peers);
               }
               at = __shfl_sync(FULL, at, c >= 0 ? __ffs(peers) - 1 : lane);
               __syncwarp();
               if (c >= 0) {
                 const int64_t pos = at + (k.smem ? 0 : k.bounds[c])
                                     + __popc(peers & below);
                 const int q = static_cast<int>(r);
                 k.vals[pos] = pow2 ? q >> shift : q / k.div;
                 if (k.slots != nullptr) {
                   k.slots[pos] = pow2 ? q & (k.div - 1) : q % k.div;
                 }
               }
             });
  }
}

// The blocks of bucket_kernel an SM holds at `smem` bytes, and the SMs, on
// the current device: asked once a (device, bytes) and kept. Its counts can
// take all of SMEM_HIST * 4 = 48 KB of dynamic shared memory (walkers * C =
// SMEM_HIST at C = 1,536, 2,048, 3,072, 4,096, 6,144 or 12,288), which with
// its static shared memory is past the default 48 KB a block: the opt-in is
// set on the device first.
cudaError_t bucket_residency(size_t smem, int* per_sm, int* sms) {
  struct Seen { int dev; size_t smem; int per_sm, sms; };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].dev == dev && seen[i].smem == smem) {
      *per_sm = seen[i].per_sm;
      *sms = seen[i].sms;
      return cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bucket_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_HIST * 4);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, bucket_kernel,
                                                      BK_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (n_seen < 64) seen[n_seen++] = Seen{dev, smem, *per_sm, *sms};
  return cudaSuccess;
}

// Cluster sched[unit / slices]'s first member and its end.
__device__ __forceinline__ void unit_of(int unit, int slices,
                                        const int32_t* __restrict__ sched,
                                        const int32_t* __restrict__ bounds,
                                        int* c, int* start, int* end) {
  *c = sched[unit / slices];
  *start = bounds[*c];
  *end = bounds[*c + 1];
}

// 16 bytes of a row as float32 columns: 4 float32 or 8 bfloat16 widened
template <bool BF16>
__device__ __forceinline__ void add16(float* acc, uint4 w) {
  if (BF16) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[2 * u] = __fadd_rn(acc[2 * u], __uint_as_float(x[u] << 16));
      acc[2 * u + 1] = __fadd_rn(acc[2 * u + 1],
                                 __uint_as_float(x[u] & 0xFFFF0000u));
    }
  } else {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(w.x));
    acc[1] = __fadd_rn(acc[1], __uint_as_float(w.y));
    acc[2] = __fadd_rn(acc[2], __uint_as_float(w.z));
    acc[3] = __fadd_rn(acc[3], __uint_as_float(w.w));
  }
}

// A warp a unit (cluster, 32 x 16 bytes of columns); d * itemsize a
// multiple of 16 and rows 16-byte aligned.
template <bool BF16>
__global__ void __launch_bounds__(SUM_WARPS * 32)
    seg_sum_ring_kernel(const void* __restrict__ rows, int64_t d,
                        const int32_t* __restrict__ order,
                        const int32_t* __restrict__ bounds,
                        const int32_t* __restrict__ sched, int units,
                        int slices, bool accumulate,
                        float* __restrict__ out) {
  constexpr int V = BF16 ? 8 : 4;  // columns a lane
  __shared__ uint4 ring[SUM_WARPS][RING][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * SUM_WARPS + warp;
  if (unit >= units) return;
  int c, start, end;
  unit_of(unit, slices, sched, bounds, &c, &start, &end);
  const int size = end - start;
  const int64_t col = static_cast<int64_t>(unit % slices) * 32 * V + lane * V;
  const bool live = col < d;
  const int64_t row_bytes = d * (BF16 ? 2 : 4);
  const char* src = static_cast<const char*>(rows) + col * (BF16 ? 2 : 4);
  uint4* slot = &ring[warp][0][lane];
  float acc[V];
  float* dst = out + static_cast<int64_t>(c) * d + col;
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = accumulate && live ? dst[u] : 0.0f;
  // member ids: lane l holds member 32 b + l of batch b (cur: the batch of
  // the next member to copy; nxt: the one after)
  int cur = lane < size ? order[start + lane] : 0;
  int nxt = 32 + lane < size ? order[start + 32 + lane] : 0;
#pragma unroll
  for (int s = 0; s < RING; ++s) {
    const int id = __shfl_sync(FULL, cur, s);
    cp_async16(slot + s * 32, src + id * row_bytes, live && s < size);
    cp_async_commit();
  }
  for (int m = 0; m < size; ++m) {
    cp_async_wait_ring();
    uint4* at = slot + (m % RING) * 32;
    add16<BF16>(acc, *at);
    const int j = m + RING;  // the member that takes this slot
    if ((j & 31) == 0) {
      cur = nxt;
      nxt = j + 32 + lane < size ? order[start + j + 32 + lane] : 0;
    }
    const int id = __shfl_sync(FULL, cur, j & 31);
    cp_async16(at, src + id * row_bytes, live && j < size);
    cp_async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!live) return;
  if (BF16) {
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(acc[V - 4], acc[V - 3], acc[V - 2], acc[V - 1]);
  } else {
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// A warp a unit of (cluster, 128 columns), 4 a lane loaded one element at
// a time: any d and alignment.
template <bool BF16>
__global__ void __launch_bounds__(SUM_WARPS * 32)
    seg_sum_scalar_kernel(const void* __restrict__ rows, int64_t d,
                          const int32_t* __restrict__ order,
                          const int32_t* __restrict__ bounds,
                          const int32_t* __restrict__ sched, int units,
                          int slices, bool accumulate,
                          float* __restrict__ out) {
  const int unit = blockIdx.x * SUM_WARPS + (threadIdx.x >> 5);
  if (unit >= units) return;
  int c, start, end;
  unit_of(unit, slices, sched, bounds, &c, &start, &end);
  const int64_t col = static_cast<int64_t>(unit % slices) * 128
                      + (threadIdx.x & 31) * 4;
  if (col >= d) return;
  const int w = static_cast<int>(d - col < 4 ? d - col : 4);
  float* dst = out + static_cast<int64_t>(c) * d + col;
  float acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = accumulate && u < w ? dst[u] : 0.0f;
  for (int m = start; m < end; ++m) {
    const int64_t at = static_cast<int64_t>(__ldg(order + m)) * d + col;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < w) {
        const float v = BF16 ? __uint_as_float(static_cast<uint32_t>(
                                   __ldg(static_cast<const uint16_t*>(rows)
                                         + at + u)) << 16)
                             : __ldg(static_cast<const float*>(rows) + at
                                     + u);
        acc[u] = __fadd_rn(acc[u], v);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < w) dst[u] = acc[u];
  }
}

template <bool BF16>
cudaError_t launch_sum(const void* rows, int64_t d, const int32_t* order,
                       const int32_t* bounds, const int32_t* sched,
                       int64_t n_clusters, bool accumulate, float* out,
                       cudaStream_t s) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(rows);
  const bool ring = (d * (BF16 ? 2 : 4)) % 16 == 0 && base % 16 == 0;
  const int64_t cols = ring ? 32 * (BF16 ? 8 : 4) : 128;
  const int slices = static_cast<int>((d + cols - 1) / cols);
  const int units = static_cast<int>(n_clusters * slices);
  const unsigned blocks = (units + SUM_WARPS - 1) / SUM_WARPS;
  if (ring) {
    seg_sum_ring_kernel<BF16><<<blocks, SUM_WARPS * 32, 0, s>>>(
        rows, d, order, bounds, sched, units, slices, accumulate, out);
  } else {
    seg_sum_scalar_kernel<BF16><<<blocks, SUM_WARPS * 32, 0, s>>>(
        rows, d, order, bounds, sched, units, slices, accumulate, out);
  }
  return cudaGetLastError();
}

// The launch of a kernel a warp a tile over c_n clusters: *smem (the
// counts and cursors a tile's warp keeps in shared memory), *warps (tile
// warps a block) and *tile_blocks.
void tile_plan(int c_n, int tiles, bool* smem, int* warps,
               unsigned* tile_blocks) {
  *smem = c_n <= SMEM_HIST;
  *warps = *smem ? max(1, min(TILE_WARPS, SMEM_HIST / c_n)) : TILE_WARPS;
  *tile_blocks = max(1, (tiles + *warps - 1) / *warps);
}

// The bucketing's first two steps on stream s: the (tile, cluster) counts
// of the assignments a (n,), then their prefixes over the tiles, the
// bounds (n_clusters + 1) and the schedule (n_clusters); `done` the scan's
// counter. Sets tile_plan's *smem, *warps and *tile_blocks.
cudaError_t bucket_counts(const int32_t* a, int64_t n, int c_n,
                          int64_t tile_rows, int tiles, int32_t* counts,
                          int32_t* bounds, int32_t* sched, int32_t* done,
                          bool* smem, int* warps, unsigned* tile_blocks,
                          cudaStream_t s) {
  tile_plan(c_n, tiles, smem, warps, tile_blocks);
  const size_t smem_bytes = *smem ? static_cast<size_t>(*warps) * c_n * 4
                                  : 0;
  cudaError_t err;
  if (!*smem && tiles > 0) {
    err = cudaMemsetAsync(counts, 0, static_cast<size_t>(tiles) * c_n * 4,
                          s);
    if (err != cudaSuccess) return err;
  }
  seg_count_kernel<<<*tile_blocks, *warps * 32, smem_bytes, s>>>(
      a, n, c_n, tile_rows, tiles, *smem, counts, done);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seg_scan_kernel<<<(c_n + 31) / 32, SCAN_WARPS * 32, 0, s>>>(
      counts, c_n, tiles, bounds, sched, done);
  return cudaGetLastError();
}

bool bad_tiling(int64_t n, int64_t n_clusters, int64_t tile_rows,
                int64_t n_tiles) {
  return n_clusters <= 0 || n_tiles > MAX_TILES || n_clusters >= (1 << 30)
         || n >= (int64_t{1} << 31)
         || (n > 0 && (tile_rows % 32 != 0 || n_tiles * tile_rows < n));
}

}  // namespace

// Segment sums of rows (n, d) float32, or bfloat16 bits when is_bf16, by
// the int32 assignments a (n,) into out (n_clusters, d) float32: each
// cluster's rows added in row order, from 0 or, with accumulate, from
// out's own values. Rows assigned outside [0, n_clusters) are in no
// cluster. scratch holds n_tiles * n_clusters + n + 2 * n_clusters + 2
// int32: the (tile, cluster) counts, then order (n), bounds (n_clusters +
// 1), the schedule (n_clusters) and the scan's counter; tiles of tile_rows
// rows (a multiple of 32), n_tiles = ceil(n / tile_rows) <= MAX_TILES
// (knn/ivf.py k9_tiles). With out null only the bucketing runs: order and
// bounds are left in scratch.
extern "C" int fk_ivf_segment_sum(const void* rows, int64_t n, int64_t d,
                                  int is_bf16, const int32_t* a,
                                  int64_t n_clusters, int64_t tile_rows,
                                  int64_t n_tiles, int32_t* scratch,
                                  int accumulate, float* out, void* stream) {
  if (bad_tiling(n, n_clusters, tile_rows, n_tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c_n = static_cast<int>(n_clusters);
  const int tiles = static_cast<int>(n_tiles);
  int32_t* counts = scratch;
  int32_t* order = counts + n_tiles * n_clusters;
  int32_t* bounds = order + n;
  int32_t* sched = bounds + n_clusters + 1;
  int32_t* done = sched + n_clusters;
  bool smem;
  int warps;
  unsigned tile_blocks;
  cudaError_t err = bucket_counts(a, n, c_n, tile_rows, tiles, counts,
                                  bounds, sched, done, &smem, &warps,
                                  &tile_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0) {
    seg_scatter_kernel<<<tile_blocks, warps * 32,
                         smem ? static_cast<size_t>(warps) * c_n * 4 : 0,
                         s>>>(a, n, c_n, tile_rows, tiles, smem, counts,
                              bounds, order);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (out == nullptr || d <= 0) return static_cast<int>(cudaSuccess);
  err = is_bf16 ? launch_sum<true>(rows, d, order, bounds, sched, n_clusters,
                                   accumulate != 0, out, s)
                : launch_sum<false>(rows, d, order, bounds, sched,
                                    n_clusters, accumulate != 0, out, s);
  return static_cast<int>(err);
}

// K11: the IVF buckets of the int32 cluster ids a (n,) over n_clusters
// (knn/ivf.py bucket_clusters), in one cooperative launch: bounds (C + 1)
// and, in bucket order (each cluster's entries r in entry order, a stable
// sort's), vals (n) the ids r / div and, where slots is given, slots (n)
// r % div; cluster c's are vals[bounds[c] : bounds[c + 1]]. Entries whose
// id is outside [0, C) are in no cluster (bounds[C] counts the others).
// With member_bounds (the member side's bounds over the same C), also
// K6's work list: units (int4: first member offset, first query offset,
// slots <= 128, members), ceil(size / 128) for each cluster of this side
// with entries, the clusters of the longest member counts (by bit length)
// first, and its length in n_units (the caller sizes units at
// ceil(n / 128) + min(C, n)). scratch holds scratch_ints int32: the
// (tile, cluster) counts (at most MAX_TILES rows; knn/ivf.py
// k11_scratch), the blocks' sums and the class totals; it is the launch's
// own (no state carries over). A refused launch returns its error.
extern "C" int fk_ivf_bucket(const int32_t* a, int64_t n, int64_t n_clusters,
                             int64_t div, const int32_t* member_bounds,
                             int32_t* vals, int32_t* slots, int32_t* bounds,
                             int32_t* units, int32_t* n_units,
                             int32_t* scratch, int64_t scratch_ints,
                             void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || n_clusters <= 0
      || n_clusters >= (1 << 30) || div < 1 || div >= (int64_t{1} << 31)
      || (member_bounds == nullptr) != (units == nullptr)
      || (units != nullptr && n_units == nullptr)
      || scratch_ints < BK_EXTRA + n_clusters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int c_n = static_cast<int>(n_clusters);
  const bool smem = c_n <= SMEM_HIST;
  const int walkers =
      smem ? std::max(1, std::min(BK_WARPS, SMEM_HIST / c_n)) : 1;
  const size_t smem_bytes = smem ? static_cast<size_t>(walkers) * c_n * 4
                                 : 0;
  int per_sm = 0, sms = 0;
  cudaError_t err = bucket_residency(smem_bytes, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t resident =
      std::min(static_cast<int64_t>(per_sm) * sms, int64_t{BK_MAX_BLOCKS});
  // a tile: a block's `walkers` warps, or one warp. Tiles of about
  // BK_RUN entries a cluster (a cluster's entries of a tile land next to
  // each other, so its scattered stores share sectors), but at least
  // BK_MIN_TILES where the entries allow
  const int64_t step = smem ? walkers : 1;
  const int64_t most =
      std::min(std::min(int64_t{MAX_TILES}, (scratch_ints - BK_EXTRA) / c_n),
               smem ? resident : resident * BK_WARPS);
  const int64_t want = std::max(int64_t{BK_MIN_TILES},
                                n / (int64_t{BK_RUN} * n_clusters));
  int64_t tiles = std::min(std::min(most, want),
                           (n + step * BK_MIN_ROWS - 1) / (step * BK_MIN_ROWS));
  int64_t wt = 32;
  if (tiles > 0) {
    wt = (n + tiles * step - 1) / (tiles * step);
    wt = (wt + 31) / 32 * 32;
    tiles = (n + wt * step - 1) / (wt * step);
  }
  const int64_t blocks =
      std::max(smem ? tiles : (tiles + BK_WARPS - 1) / BK_WARPS,
               (n_clusters + BK_WARPS - 1) / BK_WARPS);
  const int grid =
      static_cast<int>(std::max(int64_t{1}, std::min(blocks, resident)));
  int nbits = 0;
  while ((int64_t{1} << nbits) < n_clusters) ++nbits;
  int32_t* counts = scratch;
  int32_t* block_sums = scratch + (scratch_ints - BK_EXTRA);
  BucketArgs k{a, n, c_n, nbits, static_cast<int>(div), walkers, smem, wt,
               static_cast<int>(tiles), counts, block_sums,
               block_sums + BK_MAX_BLOCKS, member_bounds, vals, slots,
               bounds, reinterpret_cast<int4*>(units), n_units};
  void* args[] = {&k};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(
                                        bucket_kernel),
                                    dim3(grid), dim3(BK_THREADS), args,
                                    smem_bytes,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
