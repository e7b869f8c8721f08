"""IVF k-NN: a spherical k-means prefilter and an exact rescore (the port of
`fedrann_tpu/knn/ivf.py`).

1. k-means over the L2-normalized rows: each row goes to the centroid of
   its largest score (both operands rounded to bfloat16, products summed
   in float32, at either precision), and each centroid becomes the
   normalized sum of its rows. The sum is order-fixed: each cluster's rows
   are added in row order, one float32 add at a time from +0.0 (bitwise
   jax.ops.segment_sum on a CPU), so two runs give the same centroids bit
   for bit (an index_add_ on a card adds in the order its atomics land).
   On a CUDA device it is one call of K9's C entry (csrc/ivf_segment_sum.cu
   `fk_ivf_segment_sum`): a stable counting sort of the assignments by
   cluster in three small kernels, then a warp a cluster and 16 bytes a
   lane of columns adding its members in order from a cp.async ring, the
   largest clusters first; no torch op between the assignments and the
   sums. On the CPU segment_sum_plain (after _segments' torch sort).
2. Each row is indexed in its `spill` nearest clusters, and each query
   probes its own `p` nearest; ties go to the lowest cluster id, as
   `lax.top_k` and `argmax` give them (zero rows score 0 everywhere).
   On a CUDA device every assignment and ranking is one launch of K4
   (topk.merge_block over the centroids); on the CPU a float32 matmul,
   _order_keys and torch.topk (top_clusters_plain). Each cluster's
   members and queries go to the rescore bucketed by cluster: on a card
   each side is one launch of K11 (csrc/ivf_segment_sum.cu
   `fk_ivf_bucket`, bucket_clusters: the count, the scan, the bounds and
   a stable scatter between grid-wide barriers of one cooperative launch;
   cluster c's ids are vals[bounds[c] : bounds[c + 1]], with no width and
   no pad), the probe side also writing K6's work list from the member
   side's bounds; nothing is read back. On the CPU the JAX package's dense
   tables padded with a sentinel (torch.bincount, a stable torch.sort and
   index scatters: member_table_plain, probe_tables_plain).
3. Rescore: every probed cluster's queries are scored against its
   members, exact scores on (score, index) int64 keys (topk._order_keys),
   so equal scores go to the lowest row index as in `knn_exact`; each
   (query, probe slot) gets its best keys in a buffer, which is then
   merged per query: a row indexed in two probed clusters is scored
   twice, so the merge keeps the higher-scoring copy of each index before
   its top-k. On a CUDA device the rescore is K6 (csrc/ivf_rescore.cu
   `fk_ivf_rescore`: a block a unit of K11's work list, a cluster and up
   to 128 of its queries, walking its true member count, each row's top k
   selected once over the first K6_FIRST members and later members
   offered against it) and the merge K7 (`fk_ivf_merge`, a warp a query
   row, a merge network over its sorted lists), each one launch, enqueued
   with the probe side's K11 before the host reads anything; the buckets'
   bounds, copied to page-locked memory between K11 and K6, give the
   plan's statistics while K6 runs; on the CPU the clusters fall
   into JAX's power-of-two (queries, members) size classes, each run as
   batched products of gathered rows in chunks capped by CHUNK_BYTES
   (rescore_plain), and the merge goes 64 Ki rows at a time
   (merge_buffers_plain).

Every returned distance is exact; recall is lost only to clusters a
query does not probe. Below a few thousand rows (or 4 rows a cluster) the
search is `knn_exact`'s.

`knn_ivf` over a mesh (`knn_ivf_sharded` rounds the cluster count to a
multiple of its entries and calls it) spreads the rescore by query rows:
every entry holds all rows (the JAX package's all-gather) and the members,
and searches the queries of its own row block, so no partial result moves
between entries and the result is the one-device search's at the same
cluster count. The k-means and the members are made once, on the mesh's
first device (`knn_ivf_sharded_multihost`: rank 0's centroids, each
rank's own rows' assignments gathered), so every entry holds the same
ones.
"""

from __future__ import annotations

import itertools
import time
from typing import NamedTuple

import numpy as np
import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.knn.topk import (
    EMPTY_KEY,
    _order_keys,
    _tma_rows,
    keys_to_host,
    knn_exact,
    merge_block,
    unit_rows,
)
from fedrann_tpu_torch.logging_utils import logger
from fedrann_tpu_torch.metrics import NO_STEPS, PIN, steps

# device bytes one batched step (an assignment chunk, a size class's
# rescore chunk) holds at once
CHUNK_BYTES = 1 << 30
# bytes a (query, member) pair of a rescore chunk holds: its float32
# score, its int64 key and torch.topk's copy of the key
RESCORE_PAIR_BYTES = 20
# rows per step of the final merge (JAX's 64k-row lax.map)
MERGE_ROWS = 1 << 16
# the low word of every key of a cluster id or row index (_order_keys)
LOW_WORD = 0xFFFFFFFF
# K9's bucketing: a warp counts and places a tile of at least K9_TILE rows
# (a multiple of 32), walked 32 at a time, at most K9_MAX_TILES tiles (its
# scan's MAX_TILES); the (tile, cluster) counts stay within K9_MAX_CELLS
# int32
K9_TILE, K9_MAX_TILES, K9_MAX_CELLS = 256, 1024, 1 << 22
# K11's scratch past its counts: the blocks' sums (at most 2,048 blocks)
# and two int32 for each of the 33 bit lengths of a member count
K11_EXTRA = 2048 + 2 * 33
# K6's work unit: a probed cluster times up to K6_ROWS of its query slots
# (csrc/ivf_rescore.cu's BM)
K6_ROWS = 128


def auto_clusters(n_rows: int) -> int:
    """Default cluster count: the power of two nearest 2*sqrt(N), clamped
    to [8, 65536] (~sqrt(N)/2 rows a cluster)."""
    target = 2.0 * float(np.sqrt(max(n_rows, 1)))
    c = 1 << int(round(np.log2(max(target, 8.0))))
    return int(min(max(c, 8), 65536))


def too_small(n: int, c: int, n_clusters) -> bool:
    """The JAX package's small-N valve: exact search below 4 rows a
    cluster, or at <= 4096 rows with the default cluster count."""
    return n < 4 * c or (n_clusters is None and n <= 4096)


def _size_class(x: int, floor: int = 128) -> int:
    """Pad a ragged extent to its power-of-two size class (floor 128)."""
    return max(floor, 1 << int(np.ceil(np.log2(max(int(x), 1)))))


def _ceil128(x: int) -> int:
    return int(-(-int(x) // 128) * 128)


def _top_clusters(en: torch.Tensor, cent: torch.Tensor, t: int,
                  bf16: bool = True,
                  chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """(N, t) int32 ids of each row's t best centroids by score, the
    lowest id first among equal scores. With bf16 both operands are
    rounded to bfloat16 and the products summed in float32 (JAX's bf16
    dot_general with preferred_element_type=f32), else float32 products.
    On a CUDA device one launch of K4 (topk.merge_block over the
    centroids, whose (score desc, index asc) keys break ties to the lowest
    id) takes every row; on the CPU the plain version, chunk_bytes of
    scores and keys at a time (top_clusters_plain)."""
    if en.device.type != "cuda":
        return top_clusters_plain(en, cent, t, bf16, chunk_bytes)
    dtype = torch.bfloat16 if bf16 else torch.float32
    keys = merge_block(None, en.to(dtype).contiguous(),
                       cent.to(dtype).contiguous(), 0, t,
                       "bf16" if bf16 else "fp32")
    return (LOW_WORD - (keys & LOW_WORD)).to(torch.int32)


def top_clusters_plain(en: torch.Tensor, cent: torch.Tensor, t: int,
                       bf16: bool = True,
                       chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """_top_clusters in plain PyTorch on any device: the float32 matmul
    of the (rounded) rows and centroids, _order_keys and torch.topk,
    chunk_bytes of scores and keys at a time."""
    c = cent.shape[0]
    cent_mm = cent.to(torch.bfloat16).float() if bf16 else cent.float()
    out = torch.empty((en.shape[0], t), dtype=torch.int32, device=en.device)
    step = max(1, chunk_bytes // (c * 24))
    for r0 in range(0, en.shape[0], step):
        rows = en[r0 : r0 + step]
        rows = rows.to(torch.bfloat16).float() if bf16 else rows.float()
        keys = _order_keys(rows @ cent_mm.T, 0)
        top = torch.topk(keys, t, dim=1).values
        out[r0 : r0 + step] = (LOW_WORD - (top & LOW_WORD)).to(torch.int32)
    return out


def member_table_plain(a: torch.Tensor, counts: torch.Tensor,
                       n_clusters: int, m: int,
                       spill: int = 1) -> torch.Tensor:
    """(C, m) int32 table of row ids per cluster in row order, padded with
    the sentinel N, in plain PyTorch on any device: a stable torch.sort of
    the assignments, then an index scatter into a table filled with the
    sentinel (JAX's argsort and scatter). With spill > 1, `a` is the
    flattened (N*spill,) row-major assignment list and each row id appears
    in `spill` clusters; `counts` their torch.bincount. The CPU search's
    member table (_members)."""
    n_flat = a.shape[0]
    n = n_flat // spill
    order = torch.sort(a, stable=True).indices
    sorted_a = a[order].long()
    offsets = torch.cumsum(counts.long(), 0) - counts.long()
    pos = torch.arange(n_flat, device=a.device) - offsets[sorted_a]
    member = torch.full((n_clusters, m), n, dtype=torch.int32,
                        device=a.device)
    member[sorted_a, pos] = (order // spill).to(torch.int32)
    return member


def probe_tables_plain(probes: torch.Tensor, qcounts: torch.Tensor,
                       n_clusters: int, qm: int):
    """The (N, p) probe lists inverted into per-cluster tables in plain
    PyTorch on any device (JAX's argsort and scatters): qtab[c] the query
    rows probing c in row order (padded with the sentinel N), stab[c] the
    probe slot each used for c; `qcounts` the flattened lists'
    torch.bincount. The CPU search's probe tables (_queries)."""
    n, p = probes.shape
    dev = probes.device
    flat_c = probes.reshape(-1)
    order = torch.sort(flat_c, stable=True).indices
    sorted_c = flat_c[order].long()
    offsets = torch.cumsum(qcounts.long(), 0) - qcounts.long()
    pos = torch.arange(n * p, device=dev) - offsets[sorted_c]
    qtab = torch.full((n_clusters, qm), n, dtype=torch.int32, device=dev)
    stab = torch.zeros((n_clusters, qm), dtype=torch.int32, device=dev)
    qtab[sorted_c, pos] = (order // p).to(torch.int32)
    stab[sorted_c, pos] = (order % p).to(torch.int32)
    return qtab, stab


def _cluster_counts(a: torch.Tensor, n_clusters: int):
    """(torch.bincount of the (n,) assignments a over n_clusters, the same
    on the host as int64), as member_table_plain and probe_tables_plain
    take them."""
    counts = torch.bincount(a, minlength=n_clusters)
    return counts, counts.cpu().numpy().astype(np.int64)


class Buckets(NamedTuple):
    """Entries r of (n,) cluster ids bucketed by cluster (K11's form):
    cluster c's are vals[bounds[c] : bounds[c + 1]] in entry order (a
    stable sort's), each as r // div, and on the probe side (queries) as
    slots, r % div, too, with K6's work list: units (the first n_units
    rows, int32: first member offset, first query offset, query slots <=
    K6_ROWS, members). All int32 on the ids' device; n_units a (1,)
    tensor, read by K6 on the card."""
    vals: torch.Tensor
    bounds: torch.Tensor
    slots: torch.Tensor | None = None
    units: torch.Tensor | None = None
    n_units: torch.Tensor | None = None


def k11_scratch(n_clusters: int) -> int:
    """int32 scratch of one K11 launch over n_clusters: the (tile,
    cluster) counts of up to K9_MAX_TILES tiles within K9_MAX_CELLS, the
    blocks' sums and the unit classes' totals and cursors (csrc/
    ivf_segment_sum.cu BK_EXTRA)."""
    tiles = min(K9_MAX_TILES, max(1, K9_MAX_CELLS // n_clusters))
    return tiles * n_clusters + K11_EXTRA


def k6_grid(n: int, n_clusters: int) -> int:
    """The most units K6 can have over n probe entries: ceil(n / K6_ROWS)
    slots' units plus one partial unit a cluster."""
    return -(-n // K6_ROWS) + min(n_clusters, n)


def bucket_clusters(a: torch.Tensor, n_clusters: int, div: int,
                    member_bounds: torch.Tensor | None = None) -> Buckets:
    """K11 (csrc/ivf_segment_sum.cu `fk_ivf_bucket`): the Buckets of the
    contiguous (n,) int32 CUDA cluster ids a over n_clusters in one
    cooperative launch (count, scan, bounds, scatter between grid-wide
    barriers): the member side (_member_side: the flattened (N * spill,)
    spill lists at div = spill), or, with the member side's bounds, the
    probe side (the flattened (N, p) probe lists at div = p) with its
    slots and K6's work list, k6_grid rows of which its first n_units are
    set (the longest member counts first, by bit length). Every output is
    a view of one torch.empty (the launch's scratch last); no host copy,
    no torch op but that. Bitwise bucket_clusters_plain (units as a set of
    rows). Counts its launches in .kernel_launches (the probe side's also
    in .probe_launches); raises on a tensor it does not take or a refused
    launch."""
    if a.device.type != "cuda" or n_clusters <= 0 or div < 1:
        raise ValueError(f"bucket_clusters: CUDA ids, at least one cluster "
                         f"and div >= 1, not {a.device}, {n_clusters}, "
                         f"{div}")
    n = a.shape[0]
    _check_assignments(a, a.device, n, "bucket_clusters")
    probe = member_bounds is not None
    if probe and (member_bounds.dtype != torch.int32
                  or member_bounds.shape != (n_clusters + 1,)
                  or member_bounds.device != a.device
                  or not member_bounds.is_contiguous()):
        raise ValueError(f"bucket_clusters: member bounds ({n_clusters + 1},"
                         f") int32 on {a.device}, not {member_bounds.dtype} "
                         f"{tuple(member_bounds.shape)} on "
                         f"{member_bounds.device}")
    grid = k6_grid(n, n_clusters) if probe else 0
    scratch = k11_scratch(n_clusters)
    # the int32 offsets in one allocation of the units (16-byte rows at its
    # start), vals, slots, bounds, the unit count and the launch's scratch
    # (views of only the outputs, pointers by offset: a view costs a few
    # us of host time)
    at = list(itertools.accumulate((0, 4 * grid, n, n * probe,
                                    n_clusters + 1, int(probe))))
    out = torch.empty(at[-1] + scratch, dtype=torch.int32, device=a.device)
    ptr = [out.data_ptr() + 4 * i for i in at]
    _build.launch("fk_ivf_bucket", a.data_ptr(), n, n_clusters, div,
                  member_bounds.data_ptr() if probe else None, ptr[1],
                  ptr[2] if probe else None, ptr[3],
                  ptr[0] if probe else None, ptr[4] if probe else None,
                  ptr[5], scratch, device=a.device)
    bucket_clusters.kernel_launches += 1
    vals, bounds = out[at[1] : at[2]], out[at[3] : at[4]]
    if not probe:
        return Buckets(vals, bounds)
    bucket_clusters.probe_launches += 1
    return Buckets(vals, bounds, out[at[2] : at[3]],
                   out[: at[1]].view(grid, 4), out[at[4] : at[5]])


bucket_clusters.kernel_launches = 0
bucket_clusters.probe_launches = 0


def bucket_clusters_plain(a: torch.Tensor, n_clusters: int, div: int,
                          member_bounds: torch.Tensor | None = None
                          ) -> Buckets:
    """bucket_clusters in plain PyTorch on any device: a stable torch.sort
    of the ids (those outside [0, C) in no cluster) and torch.bincount;
    the units as bucket_units_plain gives them (exactly n_units rows)."""
    a = a.long()
    key = torch.where((a >= 0) & (a < n_clusters), a, n_clusters)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_clusters + 1)[:n_clusters]
    bounds = torch.zeros(n_clusters + 1, dtype=torch.int64, device=a.device)
    bounds[1:] = torch.cumsum(counts, 0)
    order = order[: int(bounds[-1])]
    vals, bounds = (order // div).int(), bounds.int()
    if member_bounds is None:
        return Buckets(vals, bounds)
    units = bucket_units_plain(member_bounds, bounds)
    return Buckets(vals, bounds, (order % div).int(), units,
                   torch.tensor([units.shape[0]], dtype=torch.int32,
                                device=a.device))


def bucket_units_plain(member_bounds: torch.Tensor,
                       bounds: torch.Tensor) -> torch.Tensor:
    """K6's work list from the member and probe buckets' bounds in plain
    PyTorch: (U, 4) int32 (first member offset, first query offset, query
    slots, members), ceil(queries / K6_ROWS) units a probed cluster, the
    clusters by the bit length of their member count, longest first, then
    by id."""
    mb, qb = member_bounds.long(), bounds.long()
    m, q = mb[1:] - mb[:-1], qb[1:] - qb[:-1]
    probed = torch.nonzero(q).flatten()
    length = torch.where(m[probed] > 0, torch.floor(torch.log2(
        m[probed].double().clamp_min(1))).long() + 1, 0)
    cl = probed[torch.sort(-length, stable=True).indices]
    per = -(-q[cl] // K6_ROWS)
    c = torch.repeat_interleave(cl, per)
    j = (torch.arange(c.shape[0], device=c.device)
         - torch.repeat_interleave(torch.cumsum(per, 0) - per, per)) \
        * K6_ROWS
    return torch.stack([mb[c], qb[c] + j, torch.clamp(q[c] - j, max=K6_ROWS),
                        m[c]], dim=1).int()


def host_units(members: Buckets, queries: Buckets) -> Buckets:
    """The probe Buckets `queries` with K6's work list made on the host
    (bucket_units_plain over the two sides' bounds, in reverse order: K6
    takes its units in any order) and uploaded in place of K11's, what K6
    on K11's list is held to."""
    units = bucket_units_plain(members.bounds.cpu(), queries.bounds.cpu())
    dev = queries.vals.device
    return queries._replace(
        units=units.flip(0).to(dev),
        n_units=torch.tensor([units.shape[0]], dtype=torch.int32,
                             device=dev))


def expand_buckets(vals: torch.Tensor, bounds: torch.Tensor, width: int,
                   pad: int) -> torch.Tensor:
    """The dense (C, width) int32 table of buckets: row c cluster c's
    vals in bucket order, then `pad` (what member_table_plain and
    probe_tables_plain give at that width)."""
    b = bounds.long()
    sizes = b[1:] - b[:-1]
    c = torch.repeat_interleave(torch.arange(sizes.shape[0],
                                             device=vals.device), sizes)
    j = torch.arange(vals.shape[0], device=vals.device) - b[:-1][c]
    table = torch.full((sizes.shape[0], width), pad, dtype=torch.int32,
                       device=vals.device)
    table[c, j] = vals[: c.shape[0]]
    return table


def table_buckets(table: torch.Tensor, counts_h) -> Buckets:
    """The member Buckets of a dense (C, m) table whose row c holds
    counts_h[c] ids (the rest padding): a hand-made table in the form K6
    takes."""
    counts = torch.as_tensor(np.asarray(counts_h, np.int64),
                             device=table.device)
    keep = torch.arange(table.shape[1], device=table.device)[None, :] \
        < counts[:, None]
    bounds = torch.zeros(table.shape[0] + 1, dtype=torch.int32,
                         device=table.device)
    bounds[1:] = torch.cumsum(counts, 0)
    return Buckets(table[keep].contiguous(), bounds)


def _segments(a: torch.Tensor, n_clusters: int):
    """(order, bounds) of the assignments a (N,): the row ids sorted
    stably by cluster, and the (C + 1,) int64 bounds of each cluster's run
    in them (cluster c's rows are order[bounds[c] : bounds[c + 1]], in row
    order). Torch ops with no host sync: the plain version of K9's own
    bucketing (segment_buckets), which runs no torch sort on the card."""
    sorted_a, order = torch.sort(a, stable=True)
    bounds = torch.searchsorted(sorted_a, torch.arange(
        n_clusters + 1, dtype=sorted_a.dtype, device=a.device))
    return order, bounds


def _segment_sum(rows: torch.Tensor, a: torch.Tensor, n_clusters: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(C, d) float32 sums of the rows (N, d) per cluster a (N,), each
    cluster's rows added in row order, one float32 add at a time, from
    +0.0 or, into `out`, from its sums (rows streamed in chunks then add
    as one pass would); bfloat16 rows are widened first. A CUDA tensor
    launches K9 (segment_sum_rows), a CPU tensor takes
    segment_sum_plain."""
    if rows.device.type == "cuda":
        return segment_sum_rows(rows.contiguous(), a, n_clusters, out)
    if rows.device.type != "cpu":
        raise ValueError(f"_segment_sum: unsupported device {rows.device}")
    return segment_sum_plain(rows, a, n_clusters, out)


def segment_sum_plain(rows: torch.Tensor, a: torch.Tensor, n_clusters: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """_segment_sum in plain PyTorch on any device, in K9's order: a loop
    over member positions j, each adding the j-th row of every cluster
    that has one to its float32 sum (the clusters ordered by size, so
    those are a prefix); bitwise jax.ops.segment_sum on a CPU."""
    order, bounds = _segments(a, n_clusters)
    sizes = bounds[1:] - bounds[:-1]
    by_size = torch.argsort(sizes, descending=True, stable=True)
    sizes_h = sizes[by_size].cpu().numpy()
    starts = bounds[:-1][by_size]
    acc = (torch.zeros((n_clusters, rows.shape[1]), dtype=torch.float32,
                       device=rows.device) if out is None
           else out[by_size])
    longest = int(sizes_h[0]) if n_clusters else 0
    active = np.searchsorted(-sizes_h, -np.arange(longest), side="left")
    for j in range(longest):
        m = int(active[j])
        acc[:m] += rows[order[starts[:m] + j]].float()
    out = torch.empty_like(acc) if out is None else out
    out[by_size] = acc
    return out


def k9_tiles(n: int, n_clusters: int,
             max_tiles: int = K9_MAX_TILES) -> tuple[int, int]:
    """(tile_rows, n_tiles) of K9's bucketing of n rows over n_clusters:
    tiles of K9_TILE rows, longer where more would pass max_tiles or
    K9_MAX_CELLS (tile, cluster) counts."""
    most = max(1, min(max_tiles, K9_MAX_CELLS // max(n_clusters, 1)))
    tile = max(K9_TILE, -(-n // most))
    tile = -(-tile // 32) * 32
    return tile, -(-n // tile)


def _k9_launch(rows, a: torch.Tensor, n_clusters: int, accumulate: int,
               out) -> torch.Tensor:
    """One call of fk_ivf_segment_sum on a's card (rows and out None: the
    bucketing alone); returns its int32 scratch: the (tile, cluster)
    counts, then order, bounds, the schedule and a counter."""
    n = a.shape[0]
    tile, n_tiles = k9_tiles(n, n_clusters)
    scratch = torch.empty(n_tiles * n_clusters + n + 2 * n_clusters + 2,
                          dtype=torch.int32, device=a.device)
    _build.launch("fk_ivf_segment_sum",
                  0 if rows is None else rows.data_ptr(),
                  n, 0 if rows is None else rows.shape[1],
                  int(rows is not None and rows.dtype == torch.bfloat16),
                  a.data_ptr(), n_clusters, tile, n_tiles, scratch.data_ptr(),
                  accumulate, 0 if out is None else out.data_ptr(),
                  device=a.device)
    return scratch


def _check_assignments(a: torch.Tensor, device, n: int, what: str) -> None:
    if a.device != device or a.dtype != torch.int32 \
            or a.shape != (n,) or not a.is_contiguous():
        raise ValueError(f"{what}: contiguous ({n},) int32 assignments on "
                         f"{device}, not {a.dtype} {tuple(a.shape)} on "
                         f"{a.device}")


def segment_buckets(a: torch.Tensor, n_clusters: int):
    """K9's bucketing alone on a card: (order, bounds) int32 of the (N,)
    int32 CUDA assignments a, equal as values to _segments' int64 pair
    (a stable sort is unique). One call of the C entry with no rows;
    counted in .kernel_launches."""
    if a.device.type != "cuda" or n_clusters <= 0:
        raise ValueError(f"segment_buckets: CUDA assignments and at least "
                         f"one cluster, not {a.device}, {n_clusters}")
    n = a.shape[0]
    _check_assignments(a, a.device, n, "segment_buckets")
    scratch = _k9_launch(None, a, n_clusters, 0, None)
    segment_buckets.kernel_launches += 1
    at = k9_tiles(n, n_clusters)[1] * n_clusters
    return scratch[at : at + n], scratch[at + n : at + n + n_clusters + 1]


segment_buckets.kernel_launches = 0


def _k9_replay(a: torch.Tensor, n_clusters: int):
    """K9's bucketing replayed in torch ops on any device, tile by tile as
    the kernels run it (k9_tiles): each tile's counts, their prefix over
    the tiles, the bounds, then each tile's rows placed at its cluster's
    bound + the tile's prefix + the rows of that cluster placed before it.
    (order, bounds) int64; the tests hold it to _segments."""
    n = a.shape[0]
    tile, n_tiles = k9_tiles(n, n_clusters)
    a = a.long()
    valid = (a >= 0) & (a < n_clusters)
    counts = torch.zeros((n_tiles, n_clusters), dtype=torch.int64,
                         device=a.device)
    for t in range(n_tiles):
        part = a[t * tile : (t + 1) * tile]
        part = part[valid[t * tile : (t + 1) * tile]]
        counts[t] = torch.bincount(part, minlength=n_clusters)
    sizes = counts.sum(0)
    bounds = torch.zeros(n_clusters + 1, dtype=torch.int64, device=a.device)
    bounds[1:] = torch.cumsum(sizes, 0)
    cursor = bounds[:-1] + torch.cumsum(counts, 0) - counts
    order = torch.empty(int(bounds[-1]), dtype=torch.int64, device=a.device)
    for t in range(n_tiles):
        for r in range(t * tile, min(n, (t + 1) * tile)):
            c = int(a[r])
            if 0 <= c < n_clusters:
                order[cursor[t, c]] = r
                cursor[t, c] += 1
    return order, bounds


def segment_sum_rows(rows: torch.Tensor, a: torch.Tensor, n_clusters: int,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """K9 (csrc/ivf_segment_sum.cu `fk_ivf_segment_sum`): _segment_sum of
    contiguous (N, d) float32 or bfloat16 CUDA rows by contiguous (N,)
    int32 assignments, in one call of its C entry, which buckets the rows
    (a stable counting sort into a torch.empty scratch) and sums them with
    no torch op between; into `out` ((C, d) float32 on the same card) when
    given. Bitwise segment_sum_plain. Counts its calls in .kernel_launches;
    raises on a tensor it does not take."""
    if rows.device.type != "cuda" or rows.dim() != 2 \
            or rows.dtype not in (torch.float32, torch.bfloat16) \
            or not rows.is_contiguous():
        raise ValueError(f"segment_sum_rows: contiguous (N, d) float32 or "
                         f"bfloat16 CUDA rows, not {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    _check_assignments(a, rows.device, rows.shape[0], "segment_sum_rows")
    d = rows.shape[1]
    if out is None:
        out = torch.empty((n_clusters, d), dtype=torch.float32,
                          device=rows.device)
        accumulate = 0
    elif out.shape != (n_clusters, d) or out.dtype != torch.float32 \
            or out.device != rows.device or not out.is_contiguous():
        raise ValueError(f"segment_sum_rows: out must be a contiguous "
                         f"({n_clusters}, {d}) float32 tensor on "
                         f"{rows.device}, not {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    else:
        accumulate = 1
    if out.numel() == 0:
        return out
    _k9_launch(rows, a, n_clusters, accumulate, out)
    segment_sum_rows.kernel_launches += 1
    return out


segment_sum_rows.kernel_launches = 0


def _kmeans(en: torch.Tensor, n_clusters: int, iters: int,
            device: torch.device | None = None, chunk_rows: int = 0,
            bf16: bool = True,
            chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """Spherical k-means on normalized rows (N, d), from the evenly strided
    rows 0, N // C, 2 (N // C), ...; empty clusters keep their centroid.
    Each pass assigns (_top_clusters) and sums (_segment_sum, which
    carries each cluster's sum on from chunk to chunk, so the sums are a
    whole pass's) chunk_rows rows at a time (all at once when 0), the
    chunks copied to `device` (en's own by default: rows in host memory
    stream through the device), each assignment step holding chunk_bytes
    of temporaries.
    Returns the (C, d) float32 centroids on `device`; the rows' assignment
    is _top_clusters(en, centroids, 1)."""
    dev = device or en.device
    n, d = en.shape
    chunk = chunk_rows or n
    init = torch.arange(n_clusters) * (n // max(n_clusters, 1))
    cent = en[init.to(en.device)].to(dev).float()
    for _ in range(iters):
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
        for r0 in range(0, n, chunk):
            rows = en[r0 : r0 + chunk].to(dev)
            a = _top_clusters(rows, cent, 1, bf16, chunk_bytes)[:, 0]
            _segment_sum(rows, a, n_clusters, sums)
        norm = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
        cent = torch.where(norm > 0, sums / torch.where(norm == 0, 1.0, norm),
                           cent)
    return cent


def _merge_buffers(buf: torch.Tensor, k: int, spill: int) -> torch.Tensor:
    """(rows, p, kk) int64 keys of each (query, probe slot), each slot's
    list sorted descending -> the (rows, min(k, p*kk)) best keys of each
    row, sorted descending; with spill > 1 each index keeps only its
    highest-scoring copy. A CUDA tensor launches K7 (merge_probe_lists),
    a CPU tensor takes merge_buffers_plain."""
    if buf.device.type == "cuda":
        return merge_probe_lists(buf, k, spill)
    return merge_buffers_plain(buf, k, spill)


def merge_buffers_plain(buf: torch.Tensor, k: int, spill: int
                        ) -> torch.Tensor:
    """_merge_buffers in plain PyTorch on any device, MERGE_ROWS rows at a
    time (any buffer: its lists need not be sorted)."""
    rows, p, kk_g = buf.shape
    w = p * kk_g
    kk = min(k, w)
    out = torch.empty((rows, kk), dtype=torch.int64, device=buf.device)
    for r0 in range(0, rows, MERGE_ROWS):
        keys = buf[r0 : r0 + MERGE_ROWS].reshape(-1, w)
        if spill > 1:
            keys = _dedup(keys)
        out[r0 : r0 + MERGE_ROWS] = torch.topk(keys, kk, dim=1).values
    return out


def _dedup(keys: torch.Tensor) -> torch.Tensor:
    """keys (rows, w) with every key but the highest of each row index
    replaced by EMPTY_KEY (a spilled row scored from two clusters)."""
    keys = torch.sort(keys, dim=1, descending=True).values
    low = keys & LOW_WORD  # the complemented index; EMPTY_KEY's is 0
    order = torch.sort(low, dim=1, stable=True).indices
    low = low.gather(1, order)
    dup_sorted = torch.zeros_like(low, dtype=torch.bool)
    dup_sorted[:, 1:] = low[:, 1:] == low[:, :-1]
    dup = torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)
    return keys.masked_fill_(dup, EMPTY_KEY)


def merge_probe_lists(buf: torch.Tensor, k: int, spill: int) -> torch.Tensor:
    """K7 (csrc/ivf_rescore.cu `fk_ivf_merge`): _merge_buffers of a CUDA
    buffer (rows, p, kk) of int64 keys whose every (query, slot) list is
    sorted descending, as both rescores write it, in one launch (a warp a
    row: the top T keys of its lists by a bitonic merge network, exact
    copies dropped when spill > 1, a row whose indices recur at other
    scores, or that needs more than the top T, finished by a p-way merge;
    _k7_replay replays it); bitwise merge_buffers_plain on such a buffer.
    Counts its launches in .kernel_launches; raises on a tensor it does
    not take."""
    if buf.device.type != "cuda" or buf.dtype != torch.int64 \
            or buf.dim() != 3 or not buf.is_contiguous():
        raise ValueError(f"merge_probe_lists: a contiguous (rows, p, kk) "
                         f"int64 CUDA buffer, not {buf.dtype} "
                         f"{tuple(buf.shape)} on {buf.device}")
    rows, p, kk_g = buf.shape
    kk = min(k, p * kk_g)
    out = torch.empty((rows, kk), dtype=torch.int64, device=buf.device)
    if rows == 0 or kk == 0:
        return out
    _build.launch("fk_ivf_merge", buf.data_ptr(), rows, p, kk_g, kk,
                  max(1, int(spill)), out.data_ptr(), device=buf.device)
    merge_probe_lists.kernel_launches += 1
    return out


merge_probe_lists.kernel_launches = 0


def _size_classes(x: np.ndarray, floor: int = 128) -> np.ndarray:
    """_size_class of every entry of x (int64)."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    return np.maximum(floor, np.left_shift(
        1, np.ceil(np.log2(x)).astype(np.int64)))


def _rescore_plan(counts_h: np.ndarray, qcounts_h: np.ndarray, qm: int,
                  m_all: int) -> dict:
    """{(query class, member class): [clusters]}: each probed cluster in
    its power-of-two (queries, members) size class (JAX's padded plan),
    each class's clusters in id order, the classes in the order of their
    first cluster."""
    probed = np.flatnonzero(qcounts_h)
    key = np.stack([np.minimum(_size_classes(qcounts_h[probed]), qm),
                    np.minimum(_size_classes(counts_h[probed]), m_all)], 1)
    classes, first, inverse = np.unique(key, axis=0, return_index=True,
                                        return_inverse=True)
    inverse = inverse.reshape(-1)
    return {(int(classes[g, 0]), int(classes[g, 1])):
            probed[inverse == g].tolist()
            for g in np.argsort(first, kind="stable")}


def _add_plan(stats: dict, counts_h: np.ndarray,
              qcounts_h: np.ndarray) -> dict:
    """Adds a rescore's plan to `stats` from its clusters' member and
    query counts: JAX's size classes (_rescore_plan over tables as wide
    as the largest counts rounded up to 128), its probed clusters and
    padded pair-scores, the real pair-scores (the sum over probed clusters
    of queries times members) and the largest cluster; returns the
    plan."""
    counts_h = counts_h.astype(np.int64)
    qcounts_h = qcounts_h.astype(np.int64)
    groups = _rescore_plan(counts_h, qcounts_h, _ceil128(qcounts_h.max()),
                           _ceil128(counts_h.max()))
    stats["pair_scores"] = stats.get("pair_scores", 0) + sum(
        len(clusters) * qcls * mcls
        for (qcls, mcls), clusters in groups.items())
    stats["size_classes"] = stats.get("size_classes", 0) + len(groups)
    stats["probed_clusters"] = (stats.get("probed_clusters", 0)
                                + sum(len(v) for v in groups.values()))
    stats["real_pair_scores"] = stats.get("real_pair_scores", 0) + int(
        (qcounts_h * counts_h).sum())
    stats["max_members"] = int(counts_h.max())
    return groups


def _member_side(a: torch.Tensor, c: int, spill: int):
    """The members of each cluster as _rescore takes them, from the
    flattened (N * spill,) spill lists a: on a card K11's Buckets
    (bucket_clusters at div = spill), on the CPU _members' dense table and
    its counts on the host."""
    if a.device.type == "cuda":
        return bucket_clusters(a.contiguous(), c, spill)
    return _members(a, c, spill)


def _rescore(en_pad: torch.Tensor, n_real: int, members, first: int,
             nq: int, probes: torch.Tensor, k: int, spill: int,
             precision: str, stats: dict, spans=NO_STEPS):
    """The (nq, min(k, ...)) int64 keys of the query rows en_pad[first :
    first + nq] over the members (_member_side's) of their probed
    clusters `probes` (nq, p): exact scores (bf16 products of the
    bf16-rounded rows at precision="bf16", float32 at "fp32", float32
    sums either way), rows >= n_real never winning. Returns a function
    that adds the plan to `stats` (_add_plan) and returns the keys. On a
    CUDA device the work is enqueued first and nothing is read back before
    it: K11 buckets the probe lists (their slots and K6's work list), the
    two buckets' bounds are copied to page-locked memory behind it, K6
    (rescore_clusters) fills the (query, probe slot) buffer and K7 merges
    it; the returned function waits on an event recorded after the copies
    alone and adds the plan while K6 runs. On the CPU the dense tables
    (_queries), rescore_plain and merge_buffers_plain. The steps of
    `spans` (metrics.steps; none by default): "fedrann.ivf.rescore"
    (on a card with the bounds' takes, PIN), "fedrann.ivf.merge" and
    "fedrann.ivf.plan"."""
    p = probes.shape[1]
    if en_pad.device.type != "cuda":
        member, counts_h = members
        with spans.span("fedrann.ivf.plan"):
            qtab, stab, qcounts_h = _queries(probes, member.shape[0])
            groups = _add_plan(stats, counts_h, qcounts_h)
        kk_g = min(k, member.shape[1])
        with spans.step("fedrann.ivf.rescore"):
            buf = rescore_plain(en_pad, n_real, member, qtab, stab, groups,
                                first, nq, p, k, kk_g)
        with spans.step("fedrann.ivf.merge"):
            keys = _merge_buffers(buf, k, spill)
        return lambda: keys
    with spans.step("fedrann.ivf.rescore"):
        queries = bucket_clusters(probes.reshape(-1),
                                  members.bounds.shape[0] - 1, p,
                                  members.bounds)
        host = []
        for b in (members.bounds, queries.bounds):
            with spans.span(PIN):
                host.append(torch.empty(b.shape, dtype=torch.int32,
                                        pin_memory=True))
            host[-1].copy_(b, non_blocking=True)
        copied = torch.cuda.current_stream(en_pad.device).record_event()
        buf = rescore_clusters(en_pad, n_real, members, queries, first, nq,
                               p, k, precision, stats)
    with spans.step("fedrann.ivf.merge"):
        keys = _merge_buffers(buf, k, spill)

    def finish() -> torch.Tensor:
        with spans.span("fedrann.ivf.plan"):
            copied.synchronize()
            counts_h, qcounts_h = (np.diff(h.numpy()).astype(np.int64)
                                   for h in host)
            _add_plan(stats, counts_h, qcounts_h)
        # the CPU search's width: its buffer holds min(k, table width)
        # keys a list, its merge min(k, p of them)
        kk = min(k, p * min(k, _ceil128(counts_h.max())))
        return keys if kk == keys.shape[1] else keys[:, :kk].contiguous()

    return finish


def rescore_plain(en_pad: torch.Tensor, n_real: int, member: torch.Tensor,
                  qtab: torch.Tensor, stab: torch.Tensor, groups: dict,
                  first: int, nq: int, p: int, k: int,
                  kk_g: int) -> torch.Tensor:
    """The (nq, p, kk_g) buffer of K6 in plain PyTorch on any device: each
    size class (_rescore_plan) as batched float32 products of its
    gathered query and member rows, in chunks capped by CHUNK_BYTES, each
    tile's top-k taken on _order_keys' keys, scattered to (query, probe
    slot); EMPTY_KEY where the members cannot fill a slot."""
    dev = en_pad.device
    q_pad = torch.cat([en_pad[first : first + nq], en_pad[-1:]]).float()
    buf = torch.full((nq + 1, p, kk_g), EMPTY_KEY, dtype=torch.int64,
                     device=dev)
    d = en_pad.shape[1]
    for (qcls, mcls), clusters in sorted(groups.items()):
        kk = min(k, mcls)
        per = (qcls + mcls) * d * 4 + qcls * mcls * RESCORE_PAIR_BYTES
        step = max(1, CHUNK_BYTES // per)
        for g0 in range(0, len(clusters), step):
            sel = torch.as_tensor(clusters[g0 : g0 + step], device=dev)
            mem = member[sel, :mcls].long()
            qt = qtab[sel, :qcls].long()
            scores = torch.bmm(q_pad[qt], en_pad[mem].float().transpose(1, 2))
            keys = _order_keys(scores, mem[:, None, :])
            del scores
            keys.masked_fill_((mem >= n_real)[:, None, :], EMPTY_KEY)
            buf[qt, stab[sel, :qcls].long(), :kk] = torch.topk(
                keys, kk, dim=2).values
            del keys
    return buf[:nq]


def rescore_clusters(en_pad: torch.Tensor, n_real: int, members: Buckets,
                     queries: Buckets, first: int, nq: int, p: int,
                     kk_g: int, precision: str,
                     stats: dict | None = None) -> torch.Tensor:
    """K6 (csrc/ivf_rescore.cu `fk_ivf_rescore`): the (nq, p, kk_g) buffer
    of rescore_plain in one launch on the card of en_pad over the member
    and probe Buckets (bucket_clusters'), a block a unit of the probe
    side's work list (its grid the list's rows, a block past the device's
    n_units returning at once), walking each cluster's true member count:
    each row's top kk_g selected once over the first K6_FIRST members,
    later members offered against it (_k6_replay replays it). The rows go
    in as bfloat16 at precision="bf16" (wgmma, float32 sums: the rows are
    bf16-rounded already, so the products are rescore_plain's), float32
    at "fp32" (FFMA), in one copy (topk._tma_rows: zero columns out to a
    16-byte pitch where the width needs them, so K6 gathers every 16-byte
    piece by cp.async; the zeros are those a stage holds past d anyway, so
    every score keeps its bits); every (query, slot) list is written
    whole, sorted descending, EMPTY_KEY past its members. Nothing is read
    back. Counts its launches in .kernel_launches (the fp32 form's also in
    .fp32_launches, those on a padded copy in .padded_launches); a launch
    puts its row pitch in `stats` as "k6_row_pitch" where given. Raises
    on a tensor it does not take."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"precision must be 'bf16' or 'fp32', not "
                         f"{precision!r}")
    if queries.units is None:
        raise ValueError("rescore_clusters: the probe side's Buckets (with "
                         "K6's work list)")
    tensors = (en_pad, members.vals, queries.vals, queries.slots,
               queries.units, queries.n_units)
    dev = en_pad.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("rescore_clusters: every tensor on one CUDA "
                         f"device, not {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.int32 or not t.is_contiguous()
           for t in tensors[1:]) or queries.units.shape[-1] != 4:
        raise ValueError("rescore_clusters: contiguous int32 buckets")
    if en_pad.shape[0] >= 1 << 31:
        raise ValueError("rescore_clusters: fewer than 2**31 rows (the "
                         "kernel keeps query rows as int32)")
    buf = torch.empty((nq, p, kk_g), dtype=torch.int64, device=dev)
    grid = queries.units.shape[0]
    if nq == 0 or kk_g == 0 or grid == 0:
        return buf.fill_(EMPTY_KEY)
    rows = _tma_rows(en_pad, torch.bfloat16 if precision == "bf16"
                     else torch.float32)
    pitch = rows.shape[1]
    _build.launch("fk_ivf_rescore", rows.data_ptr(), pitch,
                  int(precision == "bf16"), members.vals.data_ptr(),
                  queries.vals.data_ptr(), queries.slots.data_ptr(),
                  queries.units.data_ptr(), queries.n_units.data_ptr(), grid,
                  first, n_real, p, kk_g, buf.data_ptr(), device=dev)
    rescore_clusters.kernel_launches += 1
    rescore_clusters.fp32_launches += precision == "fp32"
    rescore_clusters.padded_launches += pitch != en_pad.shape[1]
    if stats is not None:
        stats["k6_row_pitch"] = pitch
    return buf


rescore_clusters.kernel_launches = 0
rescore_clusters.fp32_launches = 0
rescore_clusters.padded_launches = 0

# K6's selection (csrc/ivf_rescore.cu): the members of the first
# selection (MR), the list slots a row keeps in shared memory (WL), the
# survivor slots a row has beside such a list or alone (SV_LS, SV_DEV),
# the keys a row gains in an overflow round (CW)
K6_FIRST = 256
K6_LIST_SLOTS = 64
K6_SURVIVORS = {True: 64, False: 128}
K6_ROUND = 16
# K7's merge network: the most keys its run holds (T_MAX)
K7_RUN_MAX = 512


def _kth_key_replay(keys: np.ndarray, need: int) -> tuple[int, int]:
    """csrc/ivf_rescore.cu `kth_key` on one row's keys (distinct, EMPTY_KEY
    unset), need >= 1: (a key with exactly need keys at or above it, the
    bisection's steps). As the kernel: the least key where need covers
    them all; else a bisection on the high words that stops at a bound
    counting exactly need, then, where the need-th key ties others at high
    word T, one on the low words of the keys at T."""
    valid = keys[keys != EMPTY_KEY]
    if need >= valid.size:
        return int(valid.min()), 0
    hi, lo = valid >> 32, valid & LOW_WORD
    a, b, steps = int(hi.min()), int(hi.max()) + 1, 0
    while b - a > 1:
        mid = a + ((b - a) >> 1)
        c = int((hi >= mid).sum())
        steps += 1
        if c == need:
            return mid << 32, steps
        if c > need:
            a = mid
        else:
            b = mid
    above = int((hi > a).sum())
    x, y = 0, 1 << 32
    while True:
        mid = x + ((y - x) >> 1)
        c = above + int(((hi == a) & (lo >= mid)).sum())
        steps += 1
        if c == need:
            return (a << 32) | mid, steps
        if c > need:
            x = mid
        else:
            y = mid


def _k6_unit_replay(keys: torch.Tensor, w: int,
                    stats: dict | None = None) -> list:
    """K6's selection on one unit replayed on arrays, a test oracle and
    not the plain version: keys (slots, members) int64 in member order
    (EMPTY_KEY for a member >= n_real) -> each slot's list as the kernel
    builds it (int64, sorted descending, at most w keys). The first
    K6_FIRST members: each row's need-th key by the bisection, the keys at
    or above it kept. Each later tile of 128: each warp's rows (16 slots)
    offer their keys above their thresholds to K6_SURVIVORS slots; a warp
    with a row past them drops the tile's keys and offers them again in
    eight rounds of K6_ROUND columns, merging its rows past the slots less
    K6_ROUND before each; rows past half the slots merge after the tile,
    every row with survivors at the end. `stats` counts the bisection
    steps, the keys emitted (kept by the first selection or offered), the
    merges and the overflowing tiles (rounds)."""
    st = stats if stats is not None else {}
    for name in ("steps", "emitted", "merges", "rounds"):
        st.setdefault(name, 0)
    keys = keys.cpu().numpy()
    mq, nm = keys.shape
    sv_cap = K6_SURVIVORS[w <= K6_LIST_SLOTS]
    first = keys[:, :K6_FIRST]
    need = min(w, int((first[0] != EMPTY_KEY).sum())) if mq else 0
    empty = np.zeros(0, np.int64)
    lists = []
    for r in range(mq):
        if need == 0:
            lists.append(empty)
            continue
        t, steps = _kth_key_replay(first[r], need)
        row = first[r]
        kept = row[(row >= t) & (row != EMPTY_KEY)]
        assert kept.size == need
        st["steps"] += steps
        st["emitted"] += need
        lists.append(-np.sort(-kept))
    surv = [empty] * mq

    def merge(r):
        both = np.concatenate([lists[r], surv[r]])
        lists[r] = -np.sort(-both)[:w]
        surv[r] = empty
        st["merges"] += 1

    def offer(r, keys_r):
        t = int(lists[r][w - 1]) if lists[r].size == w else EMPTY_KEY
        sel = keys_r[(keys_r != EMPTY_KEY) & (keys_r > t)]
        surv[r] = np.concatenate([surv[r], sel])
        st["emitted"] += sel.size

    for t0 in range(K6_FIRST, nm, 128):
        tile = keys[:, t0 : t0 + 128]
        for r0 in range(0, mq, 16):
            rows = range(r0, min(mq, r0 + 16))
            held = [surv[r].size for r in rows]
            for r in rows:
                offer(r, tile[r])
            if any(surv[r].size > sv_cap for r in rows):
                for r, h in zip(rows, held):
                    surv[r] = surv[r][:h]
                st["rounds"] += 1
                for ro in range(8):
                    for r in rows:
                        if surv[r].size > sv_cap - K6_ROUND:
                            merge(r)
                    for r in rows:
                        offer(r, tile[r, ro * K6_ROUND : (ro + 1) * K6_ROUND])
            for r in rows:
                if surv[r].size > sv_cap // 2:
                    merge(r)
    for r in range(mq):
        if surv[r].size:
            merge(r)
    return lists


def _k6_replay(en_pad: torch.Tensor, n_real: int, members: Buckets,
               queries: Buckets, first: int, nq: int, p: int, kk_g: int,
               stats: dict | None = None) -> torch.Tensor:
    """rescore_clusters' buffer by K6's units (the probe Buckets' work
    list) and selection replayed on tensors (_k6_unit_replay): each
    unit's float32 scores as rescore_plain takes them (exact on grid
    rows), _order_keys, EMPTY_KEY past the members and for a member >=
    n_real."""
    buf = torch.full((nq, p, kk_g), EMPTY_KEY, dtype=torch.int64)
    rows = en_pad.float().cpu()
    mv, qv, qs = (t.long().cpu() for t in (members.vals, queries.vals,
                                           queries.slots))
    units = queries.units[: int(queries.n_units[0])].tolist()
    for m0, q0, mq, nm in units:
        q, s, ids = qv[q0 : q0 + mq], qs[q0 : q0 + mq], mv[m0 : m0 + nm]
        keys = _order_keys(rows[first + q] @ rows[ids].T, ids[None, :])
        keys.masked_fill_((ids >= n_real)[None, :], EMPTY_KEY)
        for r, lst in enumerate(_k6_unit_replay(keys, kk_g, stats)):
            buf[q[r], s[r], : lst.size] = torch.from_numpy(lst)
    return buf


def _merge_top_replay(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """csrc/keys_sm90.cuh `merge_top` on rows of runs a, b (rows, T), each
    sorted descending: the larger of a[e] and b[T - 1 - e], then the
    bitonic clean (half-cleaners of spans T / 2 .. 1, the lower element
    of each pair keeping the larger key)."""
    m = torch.maximum(a, b.flip(1))
    e = torch.arange(m.shape[1])
    j = m.shape[1] // 2
    while j >= 1:
        other = m[:, e ^ j]
        m = torch.where((e & j) == 0, torch.maximum(m, other),
                        torch.minimum(m, other))
        j //= 2
    return m


def _k7_run(k: int, p: int, spill: int) -> int:
    """K7's network run T: at least 64 and k times the copies an index has
    in a rescore's lists (min(spill, p) with dedup), up to K7_RUN_MAX."""
    need = k * (min(spill, p) if spill > 1 else 1)
    t = 64
    while t < need and t < K7_RUN_MAX:
        t *= 2
    return t


def _pop_merge_replay(lists: torch.Tensor, k: int, dedup: bool
                      ) -> torch.Tensor:
    """K7's exact finish on one row's sorted lists (p, L): the largest head
    each step (the lowest list among equal keys), an index already taken
    dropped with dedup; EMPTY_KEY ends the walk and fills the tail."""
    p, n = lists.shape
    pos = [0] * p
    out = []
    taken = set()
    while len(out) < k:
        heads = [int(lists[l, pos[l]]) if pos[l] < n else EMPTY_KEY
                 for l in range(p)]
        best = max(range(p), key=lambda l: (heads[l], -l))
        key = heads[best]
        if key == EMPTY_KEY:
            break
        if not dedup or key & LOW_WORD not in taken:
            out.append(key)
            taken.add(key & LOW_WORD)
        pos[best] += 1
    return torch.tensor(out + [EMPTY_KEY] * (k - len(out)), dtype=torch.int64)


def _k7_replay(buf: torch.Tensor, k: int, spill: int
               ) -> tuple[torch.Tensor, int]:
    """merge_probe_lists replayed on tensors, a test oracle and not the
    plain version: (the merged keys, the rows finished exactly). Each row's
    top T (_k7_run) by the merge network over its lists' first T keys
    (_merge_top_replay); without dedup its first K; with dedup the first
    of each run of exact copies kept, EMPTY_KEY dropped, and the first K
    kept (EMPTY_KEY past them) where no index recurs among them and there
    are K, or the T-th key is EMPTY_KEY; the other rows by the p-way merge
    (_pop_merge_replay)."""
    rows, p, n = buf.shape
    kk = min(k, p * n)
    t = _k7_run(kk, p, spill)
    dedup = spill > 1
    run = torch.full((rows, p, t), EMPTY_KEY, dtype=torch.int64)
    run[:, :, : min(n, t)] = buf[:, :, :t].cpu()
    a = run[:, 0]
    for lst in range(1, p):
        a = _merge_top_replay(a, run[:, lst])
    out = torch.full((rows, kk), EMPTY_KEY, dtype=torch.int64)
    exact = torch.zeros(rows, dtype=torch.bool) | (kk > t)
    if not dedup:
        out[:, : min(kk, t)] = a[:, :kk]
    else:
        prev = torch.cat([a.new_full((rows, 1), EMPTY_KEY), a[:, :-1]], 1)
        keep = (a != EMPTY_KEY) & ((torch.arange(t) == 0) | (a != prev))
        for r in range(rows):
            kept = a[r][keep[r]]
            low = kept & LOW_WORD
            twice = low.unique().numel() < low.numel()
            if twice or (kept.numel() < kk and int(a[r, -1]) != EMPTY_KEY):
                exact[r] = True
            else:
                out[r, : min(kk, kept.numel())] = kept[:kk]
    for r in torch.nonzero(exact).flatten().tolist():
        out[r] = _pop_merge_replay(buf[r].cpu(), kk, dedup)
    return out, int(exact.sum())


def _unit_padded(emb: torch.Tensor, precision: str) -> torch.Tensor:
    """(N + 1, d) float32: the rows as the search scores them
    (topk.unit_rows), then one zero row, the member tables' sentinel."""
    en = unit_rows(emb, precision)
    return torch.cat([en, en.new_zeros((1, en.shape[1]))])


def _tables(en: torch.Tensor, c: int, kmeans_iters: int, spill: int,
            p: int, spans=NO_STEPS):
    """(centroids, top (N, max(spill, p)) cluster ids) of rows en; the
    steps "fedrann.ivf.kmeans" and "fedrann.ivf.probes" of `spans`."""
    with spans.step("fedrann.ivf.kmeans"):
        cent = _kmeans(en, c, kmeans_iters)
    with spans.step("fedrann.ivf.probes"):
        return cent, _top_clusters(en, cent, max(spill, p))


def _members(a: torch.Tensor, c: int, spill: int):
    """(member table, counts on the host) of the flattened (N*spill,)
    assignments a, the CPU search's dense form (member_table_plain); the
    table's width is the largest count rounded up to a multiple of
    128."""
    counts, counts_h = _cluster_counts(a, c)
    return (member_table_plain(a, counts, c, _ceil128(counts_h.max()),
                               spill), counts_h)


def _queries(probes: torch.Tensor, c: int):
    """(qtab, stab, query counts on the host) of the (nq, p) probe lists
    over c clusters, the CPU search's dense form (probe_tables_plain); the
    tables' width is the largest count rounded up to a multiple of 128."""
    qcounts, qcounts_h = _cluster_counts(probes.reshape(-1), c)
    return (*probe_tables_plain(probes, qcounts, c,
                                _ceil128(qcounts_h.max())), qcounts_h)


def _log_search(name: str, n: int, c: int, p: int, spill: int,
                stats: dict) -> None:
    """Adds the search's shape to `stats` and logs it with the rescore's
    work, the real pair scores (N^2 over them: the share of the exact
    search's), and a recorded call's device ms a step."""
    stats.update(rows=n, clusters=c, probes=p, spill=spill)
    real = stats["real_pair_scores"]
    logger.info(
        "%s: %d rows, C=%d clusters (mean %.0f, max %d rows, spill %d), "
        "p=%d probes; rescore: %d probed clusters, %.2e pair scores "
        "(%.1fx fewer than exact)", name, n, c, spill * n / c,
        stats["max_members"], spill, p, stats["probed_clusters"], real,
        float(n) * n / max(real, 1))
    if "device_ms" in stats:
        logger.info("%s: device ms %s", name, ", ".join(
            f"{step} {ms:.3f}" for step, ms in stats["device_ms"].items()))


def knn_ivf(
    embeddings,
    n_neighbors: int,
    n_clusters: int | None = None,
    n_probes: int = 8,
    kmeans_iters: int = 3,
    precision: str = "bf16",
    transfer: str = "f32",
    spill: int = 2,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Sub-quadratic all-vs-all cosine top-k on the device the (N, d)
    embeddings lie on: knn_exact's output contract ((indices (N, k) int32,
    distances (N, k) float32) sorted ascending, self normally at rank 0),
    with neighbors outside the probed clusters missed and -1 / inf in a
    slot that the probed clusters cannot fill. With `mesh`
    (parallel.mesh.Mesh) the rows, the k-means and the tables are made on
    its first device and the rescore is spread over its entries by query
    rows (_search_blocks), each entry's keys taken to the host in turn and
    concatenated; the keys are those of the search without a mesh. Counts
    its calls in `.calls`, those that fell back to knn_exact (with a mesh
    knn_exact_sharded) in `.exact_fallbacks`; the last search's C, p,
    spill, real pair scores, and JAX's size classes and padded pair-scores
    are in `.last` (on a card also the row pitch K6 launched at,
    "k6_row_pitch"; with a mesh its "entries" and each entry's query rows
    and real pair scores, "entry_rows" and "entry_pairs"). While a torch
    profiler runs (metrics.steps) its steps are spans
    ("fedrann.ivf.normalize", ".kmeans", ".probes", ".members", with a
    mesh ".replicate", then each entry's ".rescore", ".merge", ".plan" and
    result_wire's, with a mesh then ".gather") and, on a card, `.last`
    also holds the call's record (metrics.Steps.record: device_ms a step
    of the first device, with "wire" where there is no mesh; pin_s,
    unpin_s, pinned_bytes; with a mesh also serial_ms, entry_ms and
    wire_s, _mesh_record)."""
    emb = torch.as_tensor(embeddings)
    n = emb.shape[0]
    c = n_clusters or auto_clusters(n)
    knn_ivf.calls += 1
    if too_small(n, c, n_clusters):
        knn_ivf.exact_fallbacks += 1
        logger.info("knn_ivf: N=%d too small for C=%d clusters; exact path",
                    n, c)
        if mesh is not None:
            from fedrann_tpu_torch.knn.ring import knn_exact_sharded

            return knn_exact_sharded(emb, n_neighbors, mesh=mesh,
                                     precision=precision, transfer=transfer)
        return knn_exact(emb, n_neighbors, precision=precision,
                         transfer=transfer)
    k, p, spill = min(n_neighbors, n), min(n_probes, c), max(1, min(spill, c))
    dev = emb.device if mesh is None else mesh.devices[0]
    spans = steps(dev)
    with spans.step("fedrann.ivf.normalize"):
        en_pad = _unit_padded(emb.to(dev), precision)
    _, top = _tables(en_pad[:n], c, kmeans_iters, spill, p, spans)
    with spans.step("fedrann.ivf.members"):
        members = _member_side(top[:, :spill].reshape(-1), c, spill)
    stats: dict = {}
    if mesh is None:
        keys = _rescore(en_pad, n, members, 0, n, top[:, :p].contiguous(),
                        k, spill, precision, stats, spans)()
        out = keys_to_host(keys, transfer, n, spans)
        stats.update(spans.record())
        name = "knn_ivf"
    else:
        stats["entries"] = mesh.size
        blocks = _search_blocks(en_pad, n, members, top[:, :p], 0, n, mesh,
                                k, spill, precision, stats, spans)
        wire0 = time.perf_counter()
        parts = []
        for keys, entry in blocks:
            entry.mark("held")
            parts.append(keys_to_host(keys, transfer, n, entry))
        with spans.span("fedrann.ivf.gather"):
            out = (np.concatenate([q[0] for q in parts]),
                   np.concatenate([q[1] for q in parts]))
        stats.update(_mesh_record(spans, [e for _, e in blocks],
                                  time.perf_counter() - wire0))
        name = f"knn_ivf over {mesh.size} entries"
    _log_search(name, n, c, p, spill, stats)
    knn_ivf.last = stats
    return out


knn_ivf.calls = 0
knn_ivf.exact_fallbacks = 0
knn_ivf.last = {}


def _mesh_record(spans, entries: list, wire_s: float) -> dict:
    """A timed mesh search's record (else {}): the first device's
    (spans') Steps.record, its device_ms the serial steps normalize to
    replicate, which the other devices wait through, and serial_ms their
    sum; entry_ms, each entry's device ms on its own stream ("lists": its
    probe lists' copy, "rescore", "merge", "held": the wait for the host
    to reach its wire, "wire"); wire_s, the host seconds from the first
    entry's take to the concatenated result; pinned_bytes the largest
    reading of the entries' takes (the last, with every entry's result
    held); pin_s and unpin_s over the whole call."""
    if not spans.timed:
        return {}
    out = spans.record()
    out.update(serial_ms=sum(out["device_ms"].values()),
               entry_ms=[e.device_ms() for e in entries], wire_s=wire_s,
               pinned_bytes=max(e.pinned_bytes for e in entries))
    return out


def _search_blocks(en_pad: torch.Tensor, n_real: int, members,
                   probes: torch.Tensor, first: int, n_rows: int, mesh,
                   k: int, spill: int, precision: str, stats: dict,
                   spans=NO_STEPS) -> list:
    """The keys of query rows first .. first + n_rows - 1 cut into one
    block per entry of `mesh` (b = ceil(n_rows / entries) rows each), each
    searched on its entry's device against every row: en_pad and the
    members (_member_side's: the buckets' vals and bounds, or the dense
    table) copied once to each distinct device (mesh.replicate, the step
    "fedrann.ivf.replicate" of `spans`), each block's probe lists to its
    entry's. Every entry's search is enqueued before any waits for its
    sizes. probes: the (n_rows, p) probe lists of those rows. Returns
    [(keys, the entry's steps)] of the entries with rows: under a profiler
    (spans not NO_STEPS) each entry's search has metrics.steps of its own
    on its device, marked after its lists' copy ("lists") and by
    _rescore. stats gains each such entry's query rows and real pair
    scores ("entry_rows", "entry_pairs")."""
    from fedrann_tpu_torch.parallel.mesh import replicate

    with spans.step("fedrann.ivf.replicate"):
        if en_pad.device.type == "cuda":
            copies = [Buckets(v, b) for v, b in zip(
                replicate(members.vals, mesh),
                replicate(members.bounds, mesh))]
        else:
            copies = [(t, members[1]) for t in replicate(members[0], mesh)]
        rows_at = replicate(en_pad, mesh)

    def pairs() -> int:  # _rescore adds an entry's at its call or finish
        return stats.get("real_pair_scores", 0)

    b = -(-n_rows // mesh.size)
    pending = []
    for j, (rows, mine) in enumerate(zip(rows_at, copies)):
        lo, hi = j * b, min(n_rows, (j + 1) * b)
        if hi > lo:
            entry = NO_STEPS if spans is NO_STEPS else steps(rows.device)
            lists = probes[lo:hi].to(rows.device).contiguous()
            entry.mark("lists")
            before = pairs()
            finish = _rescore(rows, n_real, mine, first + lo, hi - lo,
                              lists, k, spill, precision, stats, entry)
            pending.append((hi - lo, entry, finish, pairs() - before))
    stats["entry_rows"], stats["entry_pairs"] = [], []
    blocks = []
    for rows, entry, finish, enqueued in pending:
        before = pairs()
        blocks.append((finish(), entry))
        stats["entry_rows"].append(rows)
        stats["entry_pairs"].append(enqueued + pairs() - before)
    return blocks


def knn_ivf_sharded(
    embeddings,
    n_neighbors: int,
    mesh=None,
    n_clusters: int | None = None,
    n_probes: int = 8,
    kmeans_iters: int = 3,
    precision: str = "bf16",
    transfer: str = "f32",
    spill: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """knn_ivf over the mesh's entries (every visible CUDA card when
    None), each searching the queries of its row block; the cluster count
    is rounded up to a multiple of the entries (the JAX package's). Below
    the small-N valve, knn_exact_sharded. Counts `.calls` and
    `.exact_fallbacks`; past the valve the search is knn_ivf's (counted in
    its `.calls`), and `.last` is knn_ivf's."""
    from fedrann_tpu_torch.knn.ring import knn_exact_sharded
    from fedrann_tpu_torch.parallel.mesh import make_mesh

    mesh = mesh if mesh is not None else make_mesh()
    emb = torch.as_tensor(embeddings)
    n = emb.shape[0]
    c = n_clusters or auto_clusters(n)
    c = -(-c // mesh.size) * mesh.size
    knn_ivf_sharded.calls += 1
    if too_small(n, c, n_clusters):
        knn_ivf_sharded.exact_fallbacks += 1
        logger.info("knn_ivf_sharded: N=%d too small for C=%d clusters; "
                    "sharded exact path", n, c)
        return knn_exact_sharded(emb, n_neighbors, mesh=mesh,
                                 precision=precision, transfer=transfer)
    out = knn_ivf(emb, n_neighbors, n_clusters=c, n_probes=n_probes,
                  kmeans_iters=kmeans_iters, precision=precision,
                  transfer=transfer, spill=spill, mesh=mesh)
    knn_ivf_sharded.last = knn_ivf.last
    return out


knn_ivf_sharded.calls = 0
knn_ivf_sharded.exact_fallbacks = 0
knn_ivf_sharded.last = {}


def _gather_rows(transport, rows: torch.Tensor, precision: str):
    """Every rank's (b, d) float32 rows, rank by rank, on the transport's
    hop device: as bfloat16 bits (half the bytes; the values are already
    bf16-rounded) at precision="bf16"."""
    hop = transport.hop_device
    if precision != "bf16":
        return torch.cat(transport.all_gather(rows.to(hop)))
    wire = rows.to(hop).to(torch.bfloat16).view(torch.uint8)
    return torch.cat(transport.all_gather(wire)).view(
        torch.bfloat16).to(torch.float32)


def knn_ivf_sharded_multihost(
    emb_local,
    n_reads_global: int,
    per_process_reads: int,
    n_neighbors: int,
    n_clusters: int | None = None,
    n_probes: int = 8,
    kmeans_iters: int = 3,
    precision: str = "bf16",
    transfer: str = "f32",
    spill: int = 2,
    *,
    mesh,
    transport,
) -> tuple[np.ndarray, np.ndarray]:
    """knn_ivf over every process's rows (the port of the JAX package's
    `knn_ivf_sharded_multihost`), the block layout of
    ring.knn_exact_sharded_multihost: emb_local is this process's (2 *
    local reads, d) rows, global rows [2 * rank * per, ...), zero-padded
    to 2 * per rows (divisible over the local mesh `mesh`). Every rank
    gathers every rank's rows once over `transport` (bfloat16 at
    precision="bf16"); rank 0's k-means centroids go to every rank; each
    rank assigns its own rows and the assignments are gathered, so every
    rank builds the same member table; each local entry searches the
    queries of its row block. The cluster count rounds up to a multiple of
    all entries. Below the small-N valve,
    ring.knn_exact_sharded_multihost. Returns (indices int32, distances
    float32) of this process's real rows in global row numbering. Counts
    `.calls` and `.exact_fallbacks`; `.last` as knn_ivf's."""
    from fedrann_tpu_torch.knn.ring import knn_exact_sharded_multihost

    n_local = mesh.size
    block_rows = 2 * per_process_reads
    if block_rows % n_local:
        raise ValueError(
            f"per-process block of {block_rows} rows does not divide over "
            f"{n_local} local devices; compute the read range with "
            "host_read_range(..., row_multiple=local device count)")
    rank, n_proc = transport.group.rank, transport.group.size
    n_real = 2 * n_reads_global
    c = n_clusters or auto_clusters(n_real)
    c = -(-c // (n_proc * n_local)) * (n_proc * n_local)
    knn_ivf_sharded_multihost.calls += 1
    if too_small(n_real, c, n_clusters):
        knn_ivf_sharded_multihost.exact_fallbacks += 1
        logger.info("knn_ivf_sharded_multihost: N=%d too small for C=%d "
                    "clusters; exact multihost path", n_real, c)
        return knn_exact_sharded_multihost(
            emb_local, n_reads_global, per_process_reads, n_neighbors,
            precision=precision, transfer=transfer, mesh=mesh,
            transport=transport)
    k, p = min(n_neighbors, n_real), min(n_probes, c)
    spill = max(1, min(spill, c))
    hop = transport.hop_device
    emb = torch.as_tensor(emb_local)
    n_mine, d = emb.shape
    local = torch.zeros((block_rows, d), dtype=torch.float32, device=hop)
    local[:n_mine] = emb.to(hop)
    rows = _gather_rows(transport, unit_rows(local, precision), precision)
    en_pad = torch.cat([rows[:n_real], rows.new_zeros((1, d))])
    del rows
    cent = (_kmeans(en_pad[:n_real], c, kmeans_iters) if rank == 0
            else torch.zeros((c, d), dtype=torch.float32, device=hop))
    cent = transport.all_gather(cent)[0]
    first = rank * block_rows
    top = _top_clusters(en_pad[first : first + n_mine], cent,
                        max(spill, p))
    mine = torch.zeros((block_rows, spill), dtype=torch.int32, device=hop)
    mine[:n_mine] = top[:, :spill]
    a = torch.cat(transport.all_gather(mine))[:n_real].reshape(-1)
    members = _member_side(a, c, spill)
    stats: dict = {"entries": n_proc * n_local}
    keys = [kk for kk, _ in _search_blocks(
        en_pad, n_real, members, top[:, :p], first, n_mine, mesh, k, spill,
        precision, stats)]
    _log_search(f"[rank {rank}] knn_ivf_sharded_multihost", n_real, c, p,
                spill, stats)
    knn_ivf_sharded_multihost.last = stats
    if not keys:
        return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
    parts = [keys_to_host(kk, transfer, n_real) for kk in keys]
    return (np.concatenate([q[0] for q in parts]),
            np.concatenate([q[1] for q in parts]))


knn_ivf_sharded_multihost.calls = 0
knn_ivf_sharded_multihost.exact_fallbacks = 0
knn_ivf_sharded_multihost.last = {}
