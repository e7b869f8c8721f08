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
- The search is knn_exact's: each candidate tile goes through
  topk.merge_block in float32 on bf16-rounded values, so ties go to the
  lowest index as there; on a CUDA device the full tile's merge is one
  CUDA graph, replayed (_GraphMerge).
"""

from __future__ import annotations

import numpy as np
import torch

from fedrann_tpu_torch.device import get_device
from fedrann_tpu_torch.knn.topk import PAIR_BYTES, keys_to_host, merge_block
from fedrann_tpu_torch.logging_utils import logger

# candidate rows per block: 256k rows x 512 dims x 2 B = 256 MB per upload
DEFAULT_BLOCK_ROWS = 1 << 18
# rows normalized per host pass, so no (N, d) float32 temporary exists
WIRE_CHUNK = 1 << 20
# a carry's empty slot: below every key topk._order_keys makes (the high
# word of a score that is not NaN is above -2^31)
EMPTY_KEY = -(1 << 63)


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
               d: int, k: int, itemsize: int) -> int:
    """Device bytes the search holds at once under a plan: the query slab
    and its int64 key carry, the two block buffers, the float32 upcasts of
    one candidate and one query tile, a merge's key tiles (PAIR_BYTES a
    pair), and the carry tiles of a merge, of _GraphMerge's inputs and
    output and of the decode (40 bytes a query row and neighbor)."""
    return (q_rows * (d * itemsize + k * 8)
            + 2 * c_rows * d * itemsize
            + (c_tile + query_tile) * d * 4
            + query_tile * c_tile * PAIR_BYTES + query_tile * k * 40)


def plan_ooc(n: int, d: int, k: int, hbm_budget: int,
             query_tile: int = 512, block_rows: int = DEFAULT_BLOCK_ROWS,
             itemsize: int = 2, candidate_tile: int = 131072
             ) -> tuple[int, int, int]:
    """(q_rows, c_rows, c_tile) for a device-memory budget in bytes, by the
    JAX package's rules: c_rows halves from block_rows until two blocks fit
    a third of the budget, and q_rows is the largest multiple of query_tile
    that the rest allows (at least one tile; more query rows per slab mean
    fewer sweeps). The candidate tile, at most candidate_tile and c_rows,
    halves first, until the plan fits with one query tile: a sweep's copy
    costs less than the merges it feeds, and a merge's fixed cost (its
    operator calls) needs a wide tile to amortize it."""
    c = block_rows
    while c > query_tile and 2 * c * d * itemsize > hbm_budget // 3:
        c //= 2
    ct = min(candidate_tile, c)
    while ct > 8 and plan_bytes(query_tile, c, ct, query_tile, d, k,
                                itemsize) > hbm_budget:
        ct //= 2
    fixed = plan_bytes(0, c, ct, query_tile, d, k, itemsize)
    q = (hbm_budget - fixed) // (d * itemsize + k * 8)
    return max(query_tile, int(q) // query_tile * query_tile), c, ct


def _blocks_sync(host: torch.Tensor, c_rows: int, device: torch.device):
    """Yield (first row, block on `device`) for each c_rows-row block of
    host, each uploaded when its turn comes (on the CPU, views of host)."""
    for lo in range(0, host.shape[0], c_rows):
        block = host[lo : lo + c_rows]
        _count_upload(block)
        yield lo, block.to(device)


def _blocks_streamed(host: torch.Tensor, c_rows: int, device: torch.device):
    """_blocks_sync on a CUDA device with the upload of block b + 1 under
    the search of block b: two pinned staging buffers and two device
    buffers, the copies on a side stream. The current (compute) stream
    waits for each block's copy; a device buffer is refilled only after
    the compute stream has passed the block that read it, and a pinned
    buffer only after its last copy has finished."""
    n, d = host.shape
    rows = min(c_rows, n)
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    pinned = [torch.empty((rows, d), dtype=host.dtype, pin_memory=True)
              for _ in range(2)]
    bufs = [torch.empty((rows, d), dtype=host.dtype, device=device)
            for _ in range(2)]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    read = [torch.cuda.Event(), torch.cuda.Event()]
    side.wait_stream(compute)  # the buffers' memory may be freshly reused

    def upload(b: int) -> None:
        s, lo = b % 2, b * c_rows
        nv = min(c_rows, n - lo)
        copied[s].synchronize()
        pinned[s][:nv].copy_(host[lo : lo + nv])
        _count_upload(pinned[s][:nv])
        with torch.cuda.stream(side):
            side.wait_event(read[s])
            bufs[s][:nv].copy_(pinned[s][:nv], non_blocking=True)
            copied[s].record(side)

    n_blocks = -(-n // c_rows)
    try:
        upload(0)
        for b in range(n_blocks):
            if b + 1 < n_blocks:
                upload(b + 1)
            s, lo = b % 2, b * c_rows
            compute.wait_event(copied[s])
            yield lo, bufs[s][: min(c_rows, n - lo)]
            read[s].record(compute)
    finally:
        side.synchronize()


class _TileMerge:
    """merge_block over the search's tiles: load(c) takes a candidate tile
    (upcast to float32 once), then each call merges a query tile into its
    carry and returns the new carry."""

    def __init__(self, k: int):
        self.k = k
        self.c = None

    def load(self, c: torch.Tensor) -> None:
        self.c = c.float()

    def __call__(self, run: torch.Tensor, q: torch.Tensor,
                 first: int) -> torch.Tensor:
        return merge_block(run, q.float(), self.c, first, self.k)


class _GraphMerge(_TileMerge):
    """_TileMerge with the full (query_tile, c_tile) merge captured once
    into a CUDA graph and replayed: one launch a merge in place of its ~45
    operator calls, whose host time the merge's device work does not hide
    at the tiles a budget allows (chip_smoke.py 8b logs both). The tiles
    and the carry are copied into the graph's inputs (the tiles' copies are
    their float32 upcasts); a ragged tile runs merge_block itself."""

    def __init__(self, qt: int, ct: int, d: int, k: int,
                 device: torch.device):
        super().__init__(k)
        self.q = torch.zeros((qt, d), dtype=torch.float32, device=device)
        self.c_full = torch.zeros((ct, d), dtype=torch.float32,
                                  device=device)
        self.run = torch.full((qt, k), EMPTY_KEY, dtype=torch.int64,
                              device=device)
        self.first = torch.zeros((), dtype=torch.int64, device=device)
        warm = torch.cuda.Stream(device)
        warm.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(warm):  # the libraries' set-up, before capture
            merge_block(self.run, self.q, self.c_full, self.first, k)
        torch.cuda.current_stream(device).wait_stream(warm)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = merge_block(self.run, self.q, self.c_full, self.first,
                                   k)

    def load(self, c: torch.Tensor) -> None:
        if c.shape[0] == self.c_full.shape[0]:
            self.c = self.c_full.copy_(c)
        else:
            super().load(c)

    def __call__(self, run: torch.Tensor, q: torch.Tensor,
                 first: int) -> torch.Tensor:
        if self.c is not self.c_full or q.shape[0] != self.q.shape[0]:
            return super().__call__(run, q, first)
        self.q.copy_(q)
        self.run.copy_(run)
        self.first.fill_(first)
        self.graph.replay()
        return run.copy_(self.out)


def _count_upload(block: torch.Tensor) -> None:
    knn_exact_ooc.blocks_uploaded += 1
    knn_exact_ooc.h2d_bytes += block.numel() * block.element_size()


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
    q_rows, c_rows, ct = plan_ooc(n, d, k, hbm_budget, query_tile,
                                  block_rows, host.element_size(),
                                  candidate_tile)
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
                           host.element_size()))
    if device.type == "cuda":
        blocks, merge = _blocks_streamed, _GraphMerge(qt, ct, d, k, device)
    else:
        blocks, merge = _blocks_sync, _TileMerge(k)
    idx_out = np.empty((n, k), np.int32)
    dist_out = np.empty((n, k), np.float32)
    for s in range(0, n, q_rows):
        rows = min(q_rows, n - s)
        slab = host[s : s + rows]
        knn_exact_ooc.slabs += 1
        knn_exact_ooc.h2d_bytes += slab.numel() * slab.element_size()
        slab = slab.to(device)
        runs = [torch.full((min(qt, rows - q0), k), EMPTY_KEY,
                           dtype=torch.int64, device=device)
                for q0 in range(0, rows, qt)]
        for lo, block in blocks(host, c_rows, device):
            for c0 in range(0, block.shape[0], ct):
                merge.load(block[c0 : c0 + ct])
                for i, run in enumerate(runs):
                    runs[i] = merge(run, slab[i * qt : (i + 1) * qt],
                                    lo + c0)
        del slab
        for i in range(len(runs)):
            rows_i = slice(s + i * qt, s + min((i + 1) * qt, rows))
            idx_out[rows_i], dist_out[rows_i] = keys_to_host(runs[i],
                                                             transfer, n)
            runs[i] = None
    return idx_out, dist_out


knn_exact_ooc.slabs = 0
knn_exact_ooc.blocks_uploaded = 0
knn_exact_ooc.h2d_bytes = 0
