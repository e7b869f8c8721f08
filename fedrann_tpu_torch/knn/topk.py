"""Exact brute-force cosine top-k (the port of `fedrann_tpu/knn/topk.py`).

Rows are L2-normalized once; scores Q . C^T are computed for query tiles
against candidate blocks and each tile keeps a running top-k, so the N x N
matrix never materializes. Selections are ordered by (-score, index): ties,
which zero-hit reads make common (a zero row is at distance exactly 1 from
everything), go to the lowest index as in the JAX package.

precision="bf16" rounds the normalized rows to bfloat16 once and
accumulates the products in float32: the bf16-input, fp32-accumulate
product. On a CUDA device every merge is one call of the hand kernel K4
(csrc/knn_merge.cu: bf16 wgmma scores on TMA-fed tiles, or float32 FFMA at
precision="fp32", with each query row's running top-k in the kernel, the
candidates split over a persistent grid as k4_units says); on the CPU its
plain version, merge_block_plain, runs the float32 matmul on the
bf16-rounded values (whose products are exact in float32), _order_keys
and torch.topk. The result's keys reach the host through keys_to_host:
on a CUDA device one launch of K10 (csrc/result_wire.cu) writes the final
indices and distances into page-locked host memory.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.metrics import NO_STEPS, PIN, UNPIN, span, steps

# Cosine distances in [0, 2] snap to a uint16 grid of step 1/DIST_SCALE
# (--knn-transfer u16), so the TSV matches the JAX package's.
DIST_SCALE = 32767.5
# an unset slot: below every key _order_keys makes (the high word of a
# score that is not NaN is above -2^31); keys_to_host returns it as index
# -1 at distance inf
EMPTY_KEY = -(1 << 63)
# K10 (result_wire) writes a result of up to this many bytes into a block
# of torch's caching host allocator, which rounds a block up to a power of
# two and keeps it for the next result of its size until the process
# ends; a larger result gets a page-locked block of its own (HostBlock),
# which goes back to the system with the result, so the locked memory
# that outlives the results stays bounded whatever their sizes. (The IVF
# rescore copies its buckets' bounds into small blocks of the same cache.)
PIN_CACHE_BYTES = 1 << 28


def quantize_dist(dist: torch.Tensor) -> torch.Tensor:
    """Distances -> grid steps in [0, 65535] (int32)."""
    return torch.round(dist * DIST_SCALE).clamp(0, 65535).to(torch.int32)


def dequantize_dist(q: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.float32(1.0 / DIST_SCALE)


def normalize_rows(e: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows; zero rows stay zero."""
    e = e.to(torch.float32)
    norm = torch.linalg.vector_norm(e, dim=1, keepdim=True)
    return e / torch.where(norm == 0, 1.0, norm)


def round_rows(en: torch.Tensor, precision: str) -> torch.Tensor:
    """Normalized rows as the search scores them: float32, rounded to
    bfloat16 once at precision="bf16" (rounding again changes nothing)."""
    if precision == "bf16":
        return en.to(torch.bfloat16).to(torch.float32)
    return en


def unit_rows(e: torch.Tensor, precision: str) -> torch.Tensor:
    """The rows the search scores: L2-normalized float32, rounded to
    bfloat16 once at precision="bf16"."""
    return round_rows(normalize_rows(e), precision)


def _fit_tile(tile: int, n: int, floor: int = 16384) -> int:
    """Clamp a block size to n, then halve it while the ragged last block
    would waste more than a quarter of a block."""
    t = min(tile, max(8, n))
    while t > floor and ((-n) % t) > t // 4:
        t //= 2
    return t


# bytes one (query, candidate) pair of merge_block_plain's tile holds at
# once: its int64 key and that key's copy in the concatenation with the
# carry (_order_keys holds 12: the float32 score, then the key); the
# kernel holds no such tile (knn/ooc.py's plan counts it on the CPU only)
PAIR_BYTES = 16

# K4's work units (csrc/knn_merge.cu): a block of K4_ROWS query rows times
# a contiguous range of candidate tiles of K4_TILE rows, at most
# K4_MAX_UNITS ranges a block (one lane each of the combining warp)
K4_ROWS = 128
K4_TILE = 128
K4_MAX_UNITS = 32
# a split unit holds at least this many tiles, so its fixed cost (the
# query tile, the first merges, the combine) stays small beside its product
K4_MIN_TILES = 8


def k4_units(m: int, n: int, k: int, sms: int) -> int:
    """The ranges K4 splits each query block's candidates into, for m query
    rows over n candidates, k neighbors, on a card of sms SMs: the U in 1..
    min(K4_MAX_UNITS, tiles // K4_MIN_TILES) (1 when that is below 1) that
    minimizes waves * (tiles / U + a unit's fixed cost), the persistent
    grid running min(blocks * U, sms) blocks; the smallest U among equals.
    Every unit holds at least one candidate tile."""
    blocks = max(1, -(-m // K4_ROWS))
    tiles = -(-n // K4_TILE)
    fixed = 2 + -(-k // 32)  # in tiles: the query tile, the first merges
    best, pick = None, 1
    for u in range(1, max(1, min(K4_MAX_UNITS, tiles // K4_MIN_TILES)) + 1):
        cost = -(-blocks * u // sms) * (tiles / u + fixed)
        if best is None or cost < best:
            best, pick = cost, u
    return pick


def k4_splits(n: int, units: int) -> list[tuple[int, int]]:
    """The candidate rows [lo, hi) of each of K4's units of a query block:
    split s holds tiles [s T / U, (s + 1) T / U) of the T = ceil(n /
    K4_TILE) tiles, as csrc/knn_merge.cu's unit_at cuts them."""
    tiles = -(-n // K4_TILE)
    return [(s * tiles // units * K4_TILE,
             min(n, (s + 1) * tiles // units * K4_TILE))
            for s in range(units)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (K4's planner reads it)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _order_keys(scores: torch.Tensor, first_index) -> torch.Tensor:
    """int64 keys that order (score desc, column index asc) as one largest-
    first integer order: the float32 bits made monotone in the high word,
    the complemented column index in the low word. The bits are made
    monotone in place, so scores is overwritten. The column indices are
    first_index + 0, 1, ... along the last dimension, first_index an int;
    or first_index is an int64 tensor of the columns' own indices,
    broadcast against scores."""
    bits = scores.contiguous().view(torch.int32)
    flip = bits >> 31  # all ones where the score is negative
    flip &= 0x7FFFFFFF
    bits ^= flip
    del flip
    keys = bits.to(torch.int64)
    keys <<= 32
    if isinstance(first_index, torch.Tensor) and first_index.dim():
        keys |= 0xFFFFFFFF - first_index
    else:
        keys |= (0xFFFFFFFF - first_index) - torch.arange(
            scores.shape[-1], dtype=torch.int64, device=scores.device)
    return keys


def _decode_keys(keys: torch.Tensor):
    """Inverse of _order_keys: (scores float32, indices int64)."""
    idx = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
    mono = (keys >> 32).to(torch.int32)
    bits = torch.where(mono < 0, mono ^ 0x7FFFFFFF, mono)
    return bits.view(torch.float32), idx


def knn_exact(
    embeddings: torch.Tensor,
    n_neighbors: int,
    query_tile: int = 512,
    candidate_tile: int = 131072,
    precision: str = "bf16",
    transfer: str = "f32",
) -> tuple[np.ndarray, np.ndarray]:
    """(N, d) embeddings -> (indices (N, k) int32, distances (N, k) float32)
    sorted by ascending distance, k = min(n_neighbors, N), self included
    (normally at rank 0). transfer="u16" snaps distances to the
    1/DIST_SCALE grid. Its spans (metrics.steps): "fedrann.knn.normalize",
    "fedrann.knn.merge" and, on a card, result_wire's."""
    spans = steps(embeddings.device, timed=False)
    with spans.span("fedrann.knn.normalize"):
        en = normalize_rows(embeddings)
    return knn_exact_block(en, en, n_neighbors, query_tile, candidate_tile,
                           precision, transfer, spans)


def knn_exact_block(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    n_neighbors: int,
    query_tile: int = 512,
    candidate_tile: int = 131072,
    precision: str = "bf16",
    transfer: str = "f32",
    spans=NO_STEPS,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k of L2-normalized query rows (m, d) over L2-normalized
    candidate rows (n, d) through merge_block, k = min(n_neighbors, n):
    (indices (m, k) int32 into the candidates, distances (m, k) float32),
    as knn_exact scores and orders them: its search of one process's rows
    over every process's rows (the multi-process runtime's host path).
    The rows go to the merge as bfloat16 at precision="bf16" (rounded to
    nearest even once), else float32. On a CUDA device the kernel holds no
    tile: one launch takes every query row over every candidate row; on
    the CPU the plain merges go tile by tile (query_tile, candidate_tile).
    The merge is the span "fedrann.knn.merge" of `spans` (metrics.steps;
    none by default), which the wire gets too."""
    n = candidates.shape[0]
    k = min(n_neighbors, n)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    with spans.span("fedrann.knn.merge"):
        q_all = queries.to(dtype).contiguous()
        c_all = (q_all if candidates is queries
                 else candidates.to(dtype).contiguous())
        m = q_all.shape[0]
        if q_all.device.type == "cuda":
            keys = merge_block(None, q_all, c_all, 0, k, precision)
        else:
            qt = min(query_tile, max(8, m))
            ct = _fit_tile(candidate_tile, n)
            keys = torch.empty((m, k), dtype=torch.int64,
                               device=q_all.device)
            for q0 in range(0, m, qt):
                q = q_all[q0 : q0 + qt]
                run = None
                for c0 in range(0, n, ct):
                    run = merge_block(run, q, c_all[c0 : c0 + ct], c0, k,
                                      precision)
                keys[q0 : q0 + qt] = run
    return keys_to_host(keys, transfer, n, spans)


def merge_block(run: torch.Tensor | None, q: torch.Tensor, c: torch.Tensor,
                first_index, k: int, precision: str = "bf16", *,
                units: int | None = None) -> torch.Tensor:
    """The running top-k of query rows q (m, d) merged with the candidate
    rows c (n, d), both float32 or both bfloat16, whose first global index
    is first_index (an int; or an (n,) int64 tensor of each row's own
    index): run, the (m, w <= k) int64 keys of the candidates seen so far
    sorted descending (a merge's output; None before the first), becomes
    the keys of the best min(k, w + n) candidates, by score descending and
    index ascending (_order_keys). precision="bf16" scores the rows rounded
    to bfloat16 (exact for rows rounded once already) with float32
    accumulation; "fp32" in float32.

    A CPU tensor takes merge_block_plain. A CUDA tensor launches K4
    (csrc/knn_merge.cu `fk_knn_merge`), counted in .kernel_launches (one a
    call, its combine kernel included; the fp32 form's also in
    .fp32_launches); it takes contiguous rows and raises
    on a dtype, device or layout it does not take. The kernel reads the
    rows by TMA, bfloat16 at precision="bf16" and as they are at "fp32":
    rows of another dtype, or whose d * itemsize is not a multiple of 16
    or whose base is not 16-byte aligned, go in as a zero-padded copy
    (_tma_rows). Each query block's candidates
    are split into `units` ranges (k4_units when None; clamped to 1..
    min(K4_MAX_UNITS, the candidate tiles)), each merged into scratch and
    then combined; the keys are the same whatever the split. The kernel
    writes the result over run where run already has its width, so run is
    consumed either way."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"precision must be 'bf16' or 'fp32', not "
                         f"{precision!r}")
    ids = first_index if isinstance(first_index, torch.Tensor) \
        and first_index.dim() else None
    tensors = [t for t in (run, q, c, ids) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return merge_block_plain(run, q, c, first_index, k, precision)
    device = q.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("merge_block: every tensor must be on one CUDA "
                         f"device or on the CPU, not "
                         f"{[str(t.device) for t in tensors]}")
    m, n, d = q.shape[0], c.shape[0], q.shape[1]
    if q.dtype != c.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"merge_block: rows must be both float32 or both "
                         f"bfloat16, not {q.dtype} and {c.dtype}")
    if q.dim() != 2 or c.dim() != 2 or c.shape[1] != d:
        raise ValueError(f"merge_block: rows of shapes {tuple(q.shape)} "
                         f"and {tuple(c.shape)}")
    if not (q.is_contiguous() and c.is_contiguous()):
        raise ValueError("merge_block: rows must be contiguous")
    if k < 1:
        raise ValueError(f"merge_block: k must be >= 1, not {k}")
    w = 0 if run is None else run.shape[1]
    if run is not None and (run.dtype != torch.int64 or run.shape[0] != m
                            or w > k or not run.is_contiguous()):
        raise ValueError(f"merge_block: run must be contiguous int64 keys "
                         f"of shape ({m}, <= {k}), not {run.dtype} "
                         f"{tuple(run.shape)}")
    if ids is not None and (ids.dtype != torch.int64 or ids.shape != (n,)
                            or not ids.is_contiguous()):
        raise ValueError(f"merge_block: indices must be contiguous int64 "
                         f"of shape ({n},)")
    width = min(k, w + n)
    out = run if run is not None and w == width else torch.empty(
        (m, width), dtype=torch.int64, device=device)
    if m == 0:
        return out
    dtype = torch.bfloat16 if precision == "bf16" else q.dtype
    same = c is q
    q = _tma_rows(q, dtype)
    c = q if same else _tma_rows(c, dtype)
    d = q.shape[1]
    tiles = -(-n // K4_TILE)
    units = (k4_units(m, n, width, sm_count(device)) if units is None
             else max(1, min(int(units), K4_MAX_UNITS, tiles)))
    parts = (torch.empty((units, m, width), dtype=torch.int64, device=device)
             if units > 1 else None)
    _build.launch(
        "fk_knn_merge", q.data_ptr(), m, c.data_ptr(), n, d,
        int(q.dtype == torch.bfloat16), int(precision == "fp32"),
        0 if ids is not None else int(first_index),
        None if ids is None else ids.data_ptr(),
        None if run is None else run.data_ptr(), w, width, out.data_ptr(),
        1, units, None if parts is None else parts.data_ptr(),
        device=device)
    merge_block.kernel_launches += 1
    merge_block.fp32_launches += precision == "fp32"
    merge_block.last_units = units
    return out


merge_block.kernel_launches = 0
merge_block.fp32_launches = 0
merge_block.last_units = 0


def tma_width(d: int, itemsize: int) -> int:
    """The row width K4 reads by TMA and K6 gathers by cp.async: d padded
    to a multiple of 16 bytes."""
    per = 16 // itemsize
    return -(-d // per) * per


def _tma_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows as K4 reads them by TMA and K6 gathers them by cp.async: of
    dtype (float32 rounded to nearest even for bfloat16, as round_rows),
    d padded with zeros to tma_width and the base 16-byte aligned, in one
    copy (the pad columns alone zeroed); x itself where it is all that
    already. A zero pad adds +-0.0 products to sums that start at +0.0,
    which changes no bits, and every path pads a given d alike, so a
    pair's score is the same bits either way."""
    d = x.shape[1]
    dp = tma_width(d, torch.empty((), dtype=dtype).element_size())
    if (x.dtype == dtype and dp == d and x.data_ptr() % 16 == 0
            and x.is_contiguous()):
        return x
    y = torch.empty((x.shape[0], dp), dtype=dtype, device=x.device)
    y[:, :d] = x
    y[:, d:] = 0
    return y


def merge_block_plain(run: torch.Tensor | None, q: torch.Tensor,
                      c: torch.Tensor, first_index, k: int,
                      precision: str = "bf16") -> torch.Tensor:
    """merge_block in plain PyTorch on any device: the rows upcast to
    float32 (rounded to bfloat16 first at precision="bf16"), q @ c.T,
    _order_keys and torch.topk over the carry and the tile. The CPU path,
    and the reference the tests and chip_smoke.py hold the kernel to."""
    q = round_rows(q.to(torch.float32), precision)
    c = round_rows(c.to(torch.float32), precision)
    keys = _order_keys(q @ c.T, first_index)
    if run is not None:
        keys = torch.cat([run, keys], dim=1)
    return torch.topk(keys, min(k, keys.shape[1]), dim=1).values


def merge_split_plain(run: torch.Tensor | None, q: torch.Tensor,
                      c: torch.Tensor, first_index, k: int,
                      precision: str = "bf16", units: int = 1
                      ) -> torch.Tensor:
    """K4's split merge in plain PyTorch: each of k4_splits' candidate
    ranges merged alone by merge_block_plain into a list of min(k, w + n)
    keys padded with EMPTY_KEY (the first range from the carry), then each
    row's best of the lists. Equal to merge_block_plain over every
    candidate, bitwise: the keys are distinct (EMPTY_KEY slots are equal
    values), so the top set is one set whatever the split."""
    width = min(k, (0 if run is None else run.shape[1]) + c.shape[0])
    ids = first_index if isinstance(first_index, torch.Tensor) \
        and first_index.dim() else None
    lists = []
    for s, (lo, hi) in enumerate(k4_splits(c.shape[0], units)):
        part = merge_block_plain(
            run if s == 0 else None, q, c[lo:hi],
            ids[lo:hi] if ids is not None else first_index + lo, width,
            precision)
        lists.append(torch.nn.functional.pad(
            part, (0, width - part.shape[1]), value=EMPTY_KEY))
    return torch.topk(torch.cat(lists, dim=1), width, dim=1).values


def u16_indices(transfer: str, n_rows: int) -> bool:
    """Whether the indices into n_rows candidates cross to the host as
    uint16: under transfer="u16" when every index fits (n_rows <= 65536),
    the JAX package's smallest exact wire (`transfer_idx`); else int32."""
    return transfer == "u16" and n_rows <= 65536


def d2h_entry_bytes(transfer: str, n_rows: int,
                    device: torch.device) -> int:
    """Bytes a neighbor entry (index and distance) takes to the host in
    keys_to_host of keys on `device`: from a card K10 writes the final
    int32 index and float32 distance, 8; elsewhere keys_to_host_plain
    copies the JAX package's wire (its `elem + idx_elem`): a 2-byte
    distance grid step under transfer="u16", else a float32, and the index
    as u16_indices says."""
    if device.type == "cuda":
        return 8
    return ((2 if transfer == "u16" else 4)
            + (2 if u16_indices(transfer, n_rows) else 4))


def keys_to_host(keys: torch.Tensor, transfer: str, n_rows: int,
                 spans=NO_STEPS):
    """(rows, k) int64 keys of candidates 0 .. n_rows - 1 -> (indices
    int32, cosine distances float32) numpy arrays; transfer="u16" snaps
    the distances to the 1/DIST_SCALE grid (the JAX package's wire), and
    the indices are those its uint16 wire carries where they fit
    (u16_indices). An EMPTY_KEY slot comes back as index -1 at distance
    inf (2.0 on the u16 grid) on either wire. CUDA keys take K10
    (result_wire: one launch into page-locked host memory, with the spans
    of `spans`), CPU keys keys_to_host_plain; the two are
    byte-identical."""
    if keys.device.type == "cuda":
        return result_wire(keys, transfer, n_rows, spans)
    return keys_to_host_plain(keys, transfer, n_rows)


def keys_to_host_plain(keys: torch.Tensor, transfer: str, n_rows: int):
    """keys_to_host in plain PyTorch on any device: the keys decoded and
    quantized by torch ops where they lie, then copied to the host, the
    uint16 wire widened there (d2h_entry_bytes an entry crosses). Where
    uint16 indices carry no spare value, the slots' mask crosses too, only
    when there is one. The CPU path, and the reference the tests and
    chip_smoke.py hold K10 to."""
    empty = keys == EMPTY_KEY
    if not bool(empty.any()):
        empty = None
    scores, idx = _decode_keys(keys)
    dist = 1.0 - scores
    if empty is not None:
        dist.masked_fill_(empty, float("inf"))
        idx.masked_fill_(empty, -1)
    if transfer == "u16":
        dist_np = dequantize_dist(_u16_to_host(quantize_dist(dist)))
    else:
        dist_np = dist.cpu().numpy()
    if not u16_indices(transfer, n_rows):
        return idx.to(torch.int32).cpu().numpy(), dist_np
    if empty is None:
        return _u16_to_host(idx), dist_np
    idx_np = _u16_to_host(idx.clamp_min(0))
    idx_np[empty.cpu().numpy()] = -1
    return idx_np, dist_np


def result_wire(keys: torch.Tensor, transfer: str, n_rows: int,
                spans=NO_STEPS):
    """K10 (csrc/result_wire.cu `fk_keys_to_host`): keys_to_host of
    contiguous (rows, k) int64 CUDA keys in one launch that writes the
    final int32 indices and float32 distances into page-locked host memory,
    then waits for its stream. Up to PIN_CACHE_BYTES of result a call takes
    its own block of torch's caching host allocator, past it a HostBlock;
    the arrays returned are numpy views that keep their block alive, so no
    later call writes over a result still held. Counts its launches in
    .kernel_launches; raises on keys it does not take. Its spans, those of
    `spans` (metrics.steps; none by default): "fedrann.wire", and inside
    it PIN (the take of page-locked memory) and "fedrann.wire.wait" (the
    synchronize); a timed `spans` gets the mark "wire" after the launch
    and the page-locked bytes held after the take (pinned_bytes)."""
    if keys.device.type != "cuda" or keys.dtype != torch.int64 \
            or keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError(f"result_wire: contiguous (rows, k) int64 CUDA "
                         f"keys, not {keys.dtype} {tuple(keys.shape)} on "
                         f"{keys.device}")
    shape = (2, *keys.shape)
    with spans.span("fedrann.wire"):
        with spans.span(PIN):
            out = (np.asarray(HostBlock(shape))
                   if 8 * keys.numel() > PIN_CACHE_BYTES
                   else torch.empty(shape, dtype=torch.int32,
                                    pin_memory=True).numpy())
        if spans.timed:
            spans.pinned_bytes = pinned_host_bytes()
        if keys.numel():
            _build.launch("fk_keys_to_host", keys.data_ptr(), keys.numel(),
                          int(transfer == "u16"),
                          int(u16_indices(transfer, n_rows)),
                          out[0].ctypes.data, out[1].ctypes.data,
                          device=keys.device)
            result_wire.kernel_launches += 1
            spans.mark("wire")
            with spans.span("fedrann.wire.wait"):
                torch.cuda.current_stream(keys.device).synchronize()
    return out[0], out[1].view(np.float32)


def pinned_host_bytes() -> int:
    """The page-locked host bytes the process holds: every live HostBlock
    and the blocks torch's caching host allocator has handed out."""
    return HostBlock.live_bytes + int(torch.cuda.memory.host_memory_stats()
                                      .get("allocated_bytes.current", 0))


class HostBlock:
    """A page-locked int32 host block of `shape` of its own
    (`fk_host_alloc`, mapped for every card), for a result past
    PIN_CACHE_BYTES: np.asarray views it, and it goes back to the system
    (`fk_host_free`, the span UNPIN) when the last array that views it
    goes. .live counts the blocks not yet freed, .live_bytes their
    bytes."""

    live = 0
    live_bytes = 0

    def __init__(self, shape: tuple):
        ptr = ctypes.c_void_p()
        self.nbytes = 4 * math.prod(shape)
        _build.launch("fk_host_alloc", self.nbytes, ctypes.addressof(ptr))
        self.ptr = ptr.value
        self.__array_interface__ = {"shape": shape, "typestr": "<i4",
                                    "data": (self.ptr, False),
                                    "version": 3}
        HostBlock.live += 1
        HostBlock.live_bytes += self.nbytes

    def __del__(self):
        with span(UNPIN):
            _build.launch("fk_host_free", self.ptr)
        HostBlock.live -= 1
        HostBlock.live_bytes -= self.nbytes


result_wire.kernel_launches = 0


def _u16_to_host(t: torch.Tensor) -> np.ndarray:
    """Integers in [0, 65535] brought to the host in 2 bytes each (offset
    into int16, so no conversion wraps), as an int32 numpy array."""
    return (t - 32768).to(torch.int16).cpu().numpy().astype(np.int32) + 32768
