"""Out-of-core exact k-NN (the port of `fedrann_tpu/knn/ooc.py`'s exact
search): the (N, d) matrix stays in host memory and streams through a
device-memory budget.

- The rows are L2-normalized on the host and rounded once into the wire
  matrix (host_wire): bfloat16, or float32 for precision="fp32".
- Query slabs as large as the budget allows stay on the device, each with
  its running top-k; every slab sweeps the candidate blocks, so the
  host-to-device traffic is (slabs + 1) x the wire matrix.
- On a CUDA device each block is copied from a pinned staging buffer on a
  side stream while the block before it is searched (_blocks_streamed).
- The search is knn_exact's: every merge goes through topk.merge_block,
  so scores and ties (the lowest index wins) are knn_exact's. On a CUDA
  device the merge kernel holds no tile, so each (query slab, candidate
  block) pair is one launch on the uploaded wire rows; on the CPU the
  plain merges go tile by tile.
"""

from __future__ import annotations

import numpy as np
import torch

from fedrann_tpu_torch.device import get_device
from fedrann_tpu_torch.knn.topk import (
    EMPTY_KEY,
    K4_MAX_UNITS,
    PAIR_BYTES,
    k4_units,
    keys_to_host,
    merge_block,
    sm_count,
    tma_width,
)
from fedrann_tpu_torch.logging_utils import logger

# candidate rows per block: 256k rows x 512 dims x 2 B = 256 MB per upload
DEFAULT_BLOCK_ROWS = 1 << 18
# rows normalized per host pass, so no (N, d) float32 temporary exists
WIRE_CHUNK = 1 << 20
# query rows whose keys are decoded at once at the end of a slab
DECODE_ROWS = 1 << 16


def host_wire(embeddings, precision: str = "bf16") -> torch.Tensor:
    """The search's wire matrix: (N, d) rows (numpy, or a CPU tensor of
    float32 or bfloat16) read as float32, L2-normalized in numpy (zero rows
    stay zero), WIRE_CHUNK rows at a time, then rounded to nearest even
    into a CPU bfloat16 tensor, or kept float32 for precision="fp32". The
    input is not changed."""
    n, d = embeddings.shape
    wire = torch.empty((n, d), dtype=(torch.bfloat16 if precision == "bf16"
                                      else torch.float32))
    for s in range(0, n, WIRE_CHUNK):
        e = embeddings[s : s + WIRE_CHUNK]
        e = (e.float().numpy() if isinstance(e, torch.Tensor)
             else np.asarray(e, np.float32))
        norms = np.linalg.norm(e, axis=1, keepdims=True)
        wire[s : s + WIRE_CHUNK] = torch.from_numpy(
            e / np.where(norms == 0, 1.0, norms)).to(wire.dtype)
    return wire


def plan_bytes(q_rows: int, c_rows: int, c_tile: int, query_tile: int,
               d: int, k: int, itemsize: int, sms: int | None = None) -> int:
    """Device bytes the search holds at once under a plan. On the CPU (sms
    None): the query slab and its int64 key carry, the two block buffers,
    the float32 upcasts of one candidate and one query tile, a merge's key
    tiles (PAIR_BYTES a pair; merge_block_plain's), and the carry tiles of
    the merges and the decode (40 bytes a query row and neighbor). On a
    card of sms SMs, where a slab and a block are one launch of K4, which
    holds no tile: the query slab and its carry, the two block buffers,
    K4's split scratch (k4_units lists of k keys a query row, where it
    splits), and where d * itemsize is not a multiple of 16 the
    zero-padded copies of the slab and a block that K4 reads by TMA
    (topk.tma_width); or, at the slab's end (the slab and blocks freed),
    the carry and the decode of DECODE_ROWS query rows at a time (40 bytes
    a query row and neighbor), whichever is more."""
    if sms is not None:
        units = k4_units(q_rows, c_rows, k, sms)
        search = (q_rows * (d * itemsize + k * 8)
                  + 2 * c_rows * d * itemsize
                  + (units * q_rows * k * 8 if units > 1 else 0)
                  + (q_rows + c_rows) * _tma_copy_row(d, itemsize))
        return max(search, q_rows * k * 8 + min(q_rows, DECODE_ROWS) * k * 40)
    return (q_rows * (d * itemsize + k * 8)
            + 2 * c_rows * d * itemsize
            + (c_tile + query_tile) * d * 4
            + query_tile * c_tile * PAIR_BYTES + query_tile * k * 40)


def _tma_copy_row(d: int, itemsize: int) -> int:
    """Bytes a row of K4's zero-padded TMA copy takes (0 where K4 reads the
    rows as they are)."""
    dp = tma_width(d, itemsize)
    return 0 if dp == d else dp * itemsize


def plan_ooc(n: int, d: int, k: int, hbm_budget: int,
             query_tile: int = 512, block_rows: int = DEFAULT_BLOCK_ROWS,
             itemsize: int = 2, candidate_tile: int = 131072,
             sms: int | None = None) -> tuple[int, int, int]:
    """(q_rows, c_rows, c_tile) for a device-memory budget in bytes, by the
    JAX package's rules: c_rows halves from block_rows until two blocks fit
    a third of the budget, and q_rows is the largest multiple of query_tile
    that the rest allows (at least one tile; more query rows per slab mean
    fewer sweeps). On the CPU (sms None) the candidate tile, at most
    candidate_tile and c_rows, halves first, until the plan fits with one
    query tile: a sweep's copy costs less than the merges it feeds, and a
    merge's fixed cost (its operator calls) needs a wide tile to amortize
    it. On a card of sms SMs (sm_count of the search's device) a slab and
    a block are one K4 launch, so the tile is the block, and q_rows is the
    largest whose plan_bytes, K4's split scratch included, fit."""
    c = block_rows
    while c > query_tile and 2 * c * d * itemsize > hbm_budget // 3:
        c //= 2
    if sms is not None:
        q_best = query_tile
        for units in range(1, K4_MAX_UNITS + 1):
            copy = _tma_copy_row(d, itemsize)
            per_row = d * itemsize + k * 8 + copy + (units * k * 8
                                                     if units > 1 else 0)
            q = (hbm_budget - 2 * c * d * itemsize - c * copy) // per_row
            q = int(q) // query_tile * query_tile
            while q > q_best and plan_bytes(q, c, c, query_tile, d, k,
                                            itemsize, sms) > hbm_budget:
                q -= query_tile  # the decode's share, where it is larger
            if q > q_best and k4_units(q, c, k, sms) <= units:
                q_best = q
        return q_best, c, c
    ct = min(candidate_tile, c)
    while ct > 8 and plan_bytes(query_tile, c, ct, query_tile, d, k,
                                itemsize) > hbm_budget:
        ct //= 2
    fixed = plan_bytes(0, c, ct, query_tile, d, k, itemsize)
    q = (hbm_budget - fixed) // (d * itemsize + k * 8)
    return max(query_tile, int(q) // query_tile * query_tile), c, ct


def _blocks_sync(host: torch.Tensor, c_rows: int, device: torch.device,
                 blocks, counter):
    """Yield (first row, block on `device`) for each c_rows-row block of
    host (the block numbers `blocks`, in order; every block when None),
    each uploaded when its turn comes (on the CPU, views of host); the
    uploads count in `counter` (the search function)."""
    for b in (range(-(-host.shape[0] // c_rows)) if blocks is None
              else blocks):
        block = host[b * c_rows : (b + 1) * c_rows]
        _count_upload(block, counter)
        yield b * c_rows, block.to(device)


def _blocks_streamed(host: torch.Tensor, c_rows: int, device: torch.device,
                     blocks, counter):
    """_blocks_sync on a CUDA device with the upload of the next block
    under the search of the current one: two pinned staging buffers and
    two device buffers, used in turn by a block's position in the list,
    the copies on a side stream. The current (compute) stream waits for
    each block's copy; a device buffer is refilled only after the compute
    stream has passed the block that read it, and a pinned buffer only
    after its last copy has finished."""
    n, d = host.shape
    rows = min(c_rows, n)
    blocks = list(range(-(-n // c_rows)) if blocks is None else blocks)
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    pinned = [torch.empty((rows, d), dtype=host.dtype, pin_memory=True)
              for _ in range(2)]
    bufs = [torch.empty((rows, d), dtype=host.dtype, device=device)
            for _ in range(2)]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    read = [torch.cuda.Event(), torch.cuda.Event()]
    side.wait_stream(compute)  # the buffers' memory may be freshly reused

    def upload(i: int) -> None:
        s, lo = i % 2, blocks[i] * c_rows
        nv = min(c_rows, n - lo)
        copied[s].synchronize()
        pinned[s][:nv].copy_(host[lo : lo + nv])
        _count_upload(pinned[s][:nv], counter)
        with torch.cuda.stream(side):
            side.wait_event(read[s])
            bufs[s][:nv].copy_(pinned[s][:nv], non_blocking=True)
            copied[s].record(side)

    try:
        if blocks:
            upload(0)
        for i, b in enumerate(blocks):
            if i + 1 < len(blocks):
                upload(i + 1)
            s, lo = i % 2, b * c_rows
            compute.wait_event(copied[s])
            yield lo, bufs[s][: min(c_rows, n - lo)]
            read[s].record(compute)
    finally:
        side.synchronize()


def _count_upload(block: torch.Tensor, counter) -> None:
    counter.blocks_uploaded += 1
    counter.h2d_bytes += block.numel() * block.element_size()


def knn_exact_ooc(
    embeddings,
    n_neighbors: int,
    hbm_budget: int,
    query_tile: int = 512,
    candidate_tile: int = 131072,
    precision: str = "bf16",
    transfer: str = "f32",
    block_rows: int = DEFAULT_BLOCK_ROWS,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k over a host-resident (N, d) matrix (numpy, or a
    CPU tensor) within a device-memory budget in bytes, on `device` (CUDA
    unless the caller asks for the CPU). The output contract is
    knn_exact's: (indices (N, k) int32, distances (N, k) float32), self
    normally at rank 0. precision="fp32" sends float32 rows (twice the
    traffic). Counts .slabs, .blocks_uploaded and .h2d_bytes (slabs and
    blocks; on the CPU the bytes read in place)."""
    device = get_device(device or "cuda")
    host = host_wire(embeddings, precision)
    n, d = host.shape
    k = min(n_neighbors, n)
    sms = sm_count(device) if device.type == "cuda" else None
    q_rows, c_rows, ct = plan_ooc(n, d, k, hbm_budget, query_tile,
                                  block_rows, host.element_size(),
                                  candidate_tile, sms)
    qt, ct = min(query_tile, max(8, n)), min(ct, n)
    n_slabs, n_blocks = -(-n // q_rows), -(-n // c_rows)
    wire_bytes = host.numel() * host.element_size()
    logger.info(
        "knn_exact_ooc: %d x %d rows host-resident (%.2f GB %s), budget "
        "%.2f GB -> %d query slabs x %d rows, %d candidate blocks x %d "
        "rows (H2D ~%.2f GB)",
        n, d, wire_bytes / 1e9, str(host.dtype).removeprefix("torch."),
        hbm_budget / 1e9, n_slabs, q_rows, n_blocks, c_rows,
        n_slabs * wire_bytes / 1e9)
    logger.info("knn_exact_ooc: candidate tile %d rows; the plan holds %d "
                "bytes on the device", ct,
                plan_bytes(q_rows, c_rows, ct, query_tile, d, k,
                           host.element_size(), sms))
    return _search(host, q_rows, c_rows, qt, ct, k, device, transfer,
                   knn_exact_ooc, precision)


def _search(host: torch.Tensor, q_rows: int, c_rows: int, qt: int, ct: int,
            k: int, device: torch.device, transfer: str, counter,
            precision: str, need=None, ids: torch.Tensor | None = None):
    """The slab loop of the out-of-core searches: each q_rows-row query
    slab of host goes to `device` and sweeps the candidate blocks need(s,
    rows) names (every block when need is None), each (qt, ct) tile pair
    merged into the slab's query tiles' carries by merge_block; on a card
    the merge kernel holds no tile, so a slab and a block are one launch.
    ids, an (N,) int64 tensor on `device`, gives each host row's own
    index (the row number when None). On a card every merge splits its
    candidates as K4 would for a full slab and block (k4_units), the split
    plan_bytes counts, so a smaller last slab takes no more scratch. Slabs,
    blocks and bytes count in `counter`. Returns (indices (N, k) int32,
    distances (N, k) float32) in host's row order."""
    n = host.shape[0]
    units = None
    if device.type == "cuda":
        blocks, qt, ct = _blocks_streamed, q_rows, c_rows
        units = k4_units(q_rows, c_rows, k, sm_count(device))
    else:
        blocks = _blocks_sync
    idx_out = np.empty((n, k), np.int32)
    dist_out = np.empty((n, k), np.float32)
    for s in range(0, n, q_rows):
        rows = min(q_rows, n - s)
        slab = host[s : s + rows]
        counter.slabs += 1
        counter.h2d_bytes += slab.numel() * slab.element_size()
        slab = slab.to(device)
        runs = [torch.full((min(qt, rows - q0), k), EMPTY_KEY,
                           dtype=torch.int64, device=device)
                for q0 in range(0, rows, qt)]
        for lo, block in blocks(host, c_rows, device,
                                None if need is None else need(s, rows),
                                counter):
            for c0 in range(0, block.shape[0], ct):
                tile = block[c0 : c0 + ct]
                first = (lo + c0 if ids is None
                         else ids[lo + c0 : lo + c0 + tile.shape[0]])
                for i, run in enumerate(runs):
                    runs[i] = merge_block(run, slab[i * qt : (i + 1) * qt],
                                          tile, first, k, precision,
                                          units=units)
        # nothing of the slab's sweep (its last block, tile and carry
        # names) outlives it into the decode and the next slab
        del slab
        block = tile = run = first = None
        for i in range(len(runs)):
            # the decode's temporaries, DECODE_ROWS query rows at a time
            for r0 in range(0, runs[i].shape[0], DECODE_ROWS):
                lo = s + i * qt + r0
                rows_i = slice(lo, lo + min(DECODE_ROWS,
                                            runs[i].shape[0] - r0))
                idx_out[rows_i], dist_out[rows_i] = keys_to_host(
                    runs[i][r0 : r0 + DECODE_ROWS], transfer, n)
            runs[i] = None
    return idx_out, dist_out


knn_exact_ooc.slabs = 0
knn_exact_ooc.blocks_uploaded = 0
knn_exact_ooc.h2d_bytes = 0


def _centroid_order(cent) -> np.ndarray:
    """The centroids (C, d) in a 1-D order along a greedy nearest-neighbor
    chain: from centroid 0, each step hops to the most similar centroid
    not yet visited (the lowest id among equals), so clusters that are
    near on the reads' overlap manifold land in nearby row blocks (the
    JAX package's `_centroid_order`, on the host)."""
    c = np.asarray(cent, np.float32)
    n = c.shape[0]
    sims = c @ c.T
    np.fill_diagonal(sims, -np.inf)
    order = np.empty(n, np.int32)
    visited = np.zeros(n, bool)
    cur = 0
    for i in range(n):
        order[i] = cur
        visited[cur] = True
        row = sims[cur].copy()
        row[visited] = -np.inf
        if i + 1 < n:
            cur = int(np.argmax(row))
    return order


def knn_ivf_ooc(
    embeddings,
    n_neighbors: int,
    hbm_budget: int,
    n_clusters: int | None = None,
    n_probes: int = 8,
    spill: int = 2,
    kmeans_iters: int = 3,
    query_tile: int = 512,
    candidate_tile: int = 131072,
    precision: str = "bf16",
    transfer: str = "f32",
    block_rows: int = DEFAULT_BLOCK_ROWS,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """IVF-pruned out-of-core cosine top-k over a host-resident (N, d)
    matrix within a device-memory budget, on `device` (CUDA unless the
    caller asks for the CPU); the port of the JAX package's `knn_ivf_ooc`.

    Spherical k-means on a strided sample of min(N, max(8C, 2^18)) rows
    (streamed through the device block by block); one pass over the
    blocks for each row's spill clusters and probes; the host rows
    reordered by home cluster along the centroid chain (_centroid_order);
    then knn_exact_ooc's slab loop at the IVF granularity (blocks of at
    most 2^15 rows, slabs of at most max(8 blocks, 2^18) rows), each slab
    uploading only its own blocks and those holding >= 0.1% of its
    queries' probe votes. Every distance is exact and every tile's keys
    carry the rows' original indices, so ties go to the lowest index as
    in knn_exact. Below the small-N valve, knn_exact_ooc. Counts .calls,
    .exact_fallbacks, .slabs, .blocks_uploaded and .h2d_bytes (the
    sample, the assignment pass, slabs and blocks); the last search's
    figures are in .last."""
    from fedrann_tpu_torch.knn.ivf import (
        _kmeans,
        _top_clusters,
        auto_clusters,
        too_small,
    )

    device = get_device(device or "cuda")
    n = embeddings.shape[0]
    k = min(n_neighbors, n)
    c_n = n_clusters or auto_clusters(n)
    knn_ivf_ooc.calls += 1
    if too_small(n, c_n, n_clusters):
        knn_ivf_ooc.exact_fallbacks += 1
        logger.info("knn_ivf_ooc: N=%d too small for C=%d clusters; exact "
                    "ooc path", n, c_n)
        return knn_exact_ooc(embeddings, n_neighbors, hbm_budget,
                             query_tile=query_tile,
                             candidate_tile=candidate_tile,
                             precision=precision, transfer=transfer,
                             block_rows=block_rows, device=device)
    p = min(n_probes, c_n)
    spill = max(1, min(spill, c_n))
    bf16 = precision == "bf16"
    host = host_wire(embeddings, precision)
    d, itemsize = host.shape[1], host.element_size()
    c_rows = block_rows
    while c_rows > query_tile and 2 * c_rows * d * itemsize > hbm_budget // 2:
        c_rows //= 2

    # k-means on a strided sample, c_rows rows on the device at a time
    n_sample = min(n, max(8 * c_n, 1 << 18))
    sample = host[:: max(1, n // n_sample)][:n_sample].contiguous()
    knn_ivf_ooc.h2d_bytes += (kmeans_iters * sample.numel()
                              * sample.element_size())
    chunk = max(1 << 20, hbm_budget // 8)  # a step's temporaries
    cent = _kmeans(sample, c_n, kmeans_iters, device, c_rows, bf16, chunk)
    del sample

    # each row's spill clusters and probes, one pass over the blocks
    top = torch.empty((n, max(spill, p)), dtype=torch.int32)
    for lo in range(0, n, c_rows):
        block = host[lo : lo + c_rows]
        knn_ivf_ooc.h2d_bytes += block.numel() * block.element_size()
        top[lo : lo + c_rows] = _top_clusters(
            block.to(device), cent, max(spill, p), bf16, chunk).cpu()
    top = top.numpy()
    assign, probes = top[:, :spill], top[:, :p]

    # host rows reordered by home cluster along the centroid chain
    crank = np.empty(c_n, np.int64)
    crank[_centroid_order(cent.cpu().numpy())] = np.arange(c_n)
    order = np.argsort(crank[assign[:, 0]], kind="stable")
    host = host[torch.from_numpy(order)]
    probes = probes[order]

    # the IVF granularity: blocks at the cluster scale, slabs of a few
    q_rows, _, ct = plan_ooc(n, d, k, hbm_budget, query_tile, c_rows,
                             itemsize, candidate_tile,
                             sm_count(device) if device.type == "cuda"
                             else None)
    c_rows = min(c_rows, 1 << 15)
    q_rows = min(q_rows, max(8 * c_rows, 1 << 18))
    qt, ct = min(query_tile, max(8, n)), min(ct, c_rows, n)
    n_blocks, n_slabs = -(-n // c_rows), -(-n // q_rows)
    # cluster -> the blocks holding any of its (spill) members
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    holds = np.zeros((c_n, n_blocks), bool)
    for s in range(spill):
        holds[assign[:, s], inv // c_rows] = True
    tally = {"votes": 0, "dropped_votes": 0, "uploads": 0}

    def need(s: int, rows: int) -> list[int]:
        """The blocks slab s searches: its own, and those with >= 0.1% of
        its queries' probe votes."""
        votes = np.bincount(probes[s : s + rows].ravel(),
                            minlength=c_n) @ holds
        keep = votes >= max(1, int(0.001 * rows))
        keep[s // c_rows : (s + rows - 1) // c_rows + 1] = True
        tally["votes"] += int(votes.sum())
        tally["dropped_votes"] += int(votes[~keep].sum())
        tally["uploads"] += int(keep.sum())
        return np.flatnonzero(keep).tolist()

    ids = torch.from_numpy(order).to(device)
    idx_r, dist_r = _search(host, q_rows, c_rows, qt, ct, k, device,
                            transfer, knn_ivf_ooc, precision, need, ids)
    idx_out = np.empty_like(idx_r)
    dist_out = np.empty_like(dist_r)
    idx_out[order], dist_out[order] = idx_r, dist_r
    knn_ivf_ooc.last = {
        "rows": n, "clusters": c_n, "probes": p, "spill": spill,
        "sample_rows": n_sample, "slabs": n_slabs, "q_rows": q_rows,
        "blocks": n_blocks, "c_rows": c_rows,
        "exact_uploads": n_slabs * n_blocks, **tally}
    logger.info(
        "knn_ivf_ooc: C=%d p=%d spill=%d -> %d/%d candidate-block uploads "
        "(%.2fx fewer than exact ooc; %.3f%% of probe votes dropped by "
        "the block threshold)", c_n, p, spill, tally["uploads"],
        n_slabs * n_blocks, n_slabs * n_blocks / max(tally["uploads"], 1),
        100.0 * tally["dropped_votes"] / max(tally["votes"], 1))
    return idx_out, dist_out


knn_ivf_ooc.calls = 0
knn_ivf_ooc.exact_fallbacks = 0
knn_ivf_ooc.slabs = 0
knn_ivf_ooc.blocks_uploaded = 0
knn_ivf_ooc.h2d_bytes = 0
knn_ivf_ooc.last = {}
