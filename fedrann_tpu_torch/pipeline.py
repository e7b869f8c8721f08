"""Pipeline orchestrator: FASTX in, overlaps.tsv out (the port of
`fedrann_tpu/pipeline.py` `run_pipeline`).

Stages, as named in metrics.json:
  load    - the packed-reads cache (fxcache.npz), else the native FASTX
            parse and 2-bit pack into length buckets (io/native.py; pinned
            host memory for a CUDA run); reads past the largest bucket
            split into k - 1-overlapped segments
  stage   - each bucket uploaded in its 2-bit form, then per-read canonical
            windows, sampling filter, candidate selection and row sort
            (kernels A and B on the packed source), chunked by window_batch;
            run lazily, so a run resumed from checkpoints skips it
  count   - library build from the staged slots (sort, run lengths,
            multiplicity and sampling filters), a library checkpoint, or
            --import-library
  project - sign-packed SRP x ICF table, a dense paired table
            (--projection-dtype f32|bf16), or --import-projection
  embed   - membership + paired embedding into the (2N, d) matrix (kernel
            C, in the projection's form), then each split read's union; or
            an embeddings checkpoint. Past --knn-hbm-budget the matrix is a
            host bfloat16 tensor filled chunk by chunk (out="host")
  knn     - exact cosine top-k, or with --knn-method ivf the IVF search
            (knn/ivf.py); with --knn-sharded always (or auto and more
            than one visible card) sharded over a device mesh
            (knn/ring.py, knn/ivf.py); past the budget, the out-of-core
            search (knn/ooc.py) streams the host matrix through one device
  output  - overlaps.tsv (native C writer), --save-feature-matrix

--keep-intermediates keeps checkpoints/library.npz, embeddings.npy and
embeddings_meta.json in the JAX package's format (each package resumes the
other's); --profile writes a torch.profiler Chrome trace to <out>/trace/;
--mprof writes mprof.dat.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from fedrann_tpu_torch.compat import (
    load_reference_library_mapping,
    load_reference_precompute,
)
from fedrann_tpu_torch.config import PipelineConfig
from fedrann_tpu_torch.io.cache import (
    cache_meta,
    load_packed_cache,
    save_packed_cache,
)
from fedrann_tpu_torch.io.native import pack_reads_native
from fedrann_tpu_torch.io.packing import PackedBucket, PackedReads, bit_pack
from fedrann_tpu_torch.io.tsv import write_overlaps_path
from fedrann_tpu_torch.kmers.codec import (
    PAD_SLOT,
    PackedChunk,
    sample_threshold,
)
from fedrann_tpu_torch.kmers.library import KmerLibrary, build_library
from fedrann_tpu_torch.kmers.membership import (
    read_hits_staged,
    selection_cap,
    stage_candidates,
    staging_width,
)
from fedrann_tpu_torch.knn.ivf import auto_clusters, knn_ivf, knn_ivf_sharded
from fedrann_tpu_torch.knn.ooc import knn_exact_ooc, knn_ivf_ooc
from fedrann_tpu_torch.knn.ring import knn_exact_sharded
from fedrann_tpu_torch.knn.topk import d2h_entry_bytes, knn_exact
from fedrann_tpu_torch.logging_utils import (
    add_log_file,
    logger,
    remove_log_file,
    set_logging_level,
)
from fedrann_tpu_torch.metrics import MemorySampler, StageMetrics, span
from fedrann_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from fedrann_tpu_torch.project.embed import (
    embed_hits,
    embed_staged,
    projection_width,
)
from fedrann_tpu_torch.project.srp import (
    build_precompute_paired,
    build_precompute_signs,
    pair_projection,
)


@dataclasses.dataclass
class PipelineResult:
    names: list[str]
    library: KmerLibrary
    # (2R, d) fwd/rev interleaved: float32 on the device, or in host
    # memory (bfloat16, or a resumed float32 file) out of core
    embeddings: torch.Tensor
    neighbor_indices: np.ndarray    # (2R, k) int32
    neighbor_distances: np.ndarray  # (2R, k) float32
    metrics: dict
    overlaps_path: Optional[str] = None
    # the embedding row of the first of `embeddings` and of the neighbor
    # rows (a rank of a multi-process run holds its own rows only)
    row_offset: int = 0


@dataclasses.dataclass
class StagedBucket:
    """One length bucket's staged candidates, on the run's device."""

    staged: torch.Tensor      # (R_b, width) int64 slots, sorted per row
    dropped: torch.Tensor     # (R_b,) int32 occurrences beyond the buffer
    read_index: torch.Tensor  # (R_b,) int64 global read index, -1 = pad row
    rows: int                 # rows per device chunk


def out_of_core(config: PipelineConfig, n_reads: int) -> bool:
    """The JAX package's valve: the (2R, d) float32 matrix and the search's
    copy (6 bytes an element) past --knn-hbm-budget."""
    return (config.knn_hbm_budget is not None
            and 2 * n_reads * config.embedding_dimension * 6
            > config.knn_hbm_budget)


def knn_mesh(config: PipelineConfig,
             devices: Sequence[torch.device]) -> Mesh:
    """The sharded k-NN's mesh over `devices`, as the JAX package builds
    it from jax.devices(): for ring2d, (H, D) = --mesh-shape over the first
    H*D devices, else (1, n) with a warning for any other shape; for ring
    and allgather, a 1-D mesh over the first prod(--mesh-shape)."""
    if config.knn_shard_strategy != "ring2d":
        return make_mesh(config.mesh_shape, devices)
    if config.mesh_shape and len(config.mesh_shape) == 2:
        n_hosts, n_local = config.mesh_shape
        return make_mesh_2d(n_hosts, devices[: n_hosts * n_local])
    if config.mesh_shape:
        logger.warning("mesh_shape %s is not (hosts, data); ring2d uses a "
                       "(1, n_devices) mesh instead", config.mesh_shape)
    return make_mesh_2d(1, devices)


def load_reads(config: PipelineConfig,
               device: torch.device | None = None) -> PackedReads:
    """The input in the native packer's 2-bit form: from the packed-reads
    cache (<output_dir>/fxcache.npz, unless --no-pack-cache) when its meta
    matches, else parsed and packed with --threads workers (in pinned host
    memory when `device` is a CUDA device) and saved to the cache. A read
    past the largest bucket is split into segments overlapping by k - 1
    bases."""
    split_overlap = config.kmer_size - 1
    cache_path = (os.path.join(config.output_dir, "fxcache.npz")
                  if config.pack_cache and config.output_dir else None)
    packed = meta = None
    if cache_path:
        meta = cache_meta(config.input_path, config.length_buckets,
                          split_overlap)
        packed = load_packed_cache(cache_path, meta)
    if packed is None:
        packed = pack_reads_native(
            config.input_path, config.length_buckets,
            threads=max(1, config.threads), split_overlap=split_overlap,
            pin_memory=device is not None and device.type == "cuda")
        if cache_path:
            os.makedirs(config.output_dir, exist_ok=True)
            save_packed_cache(cache_path, packed, meta)
    if packed.n_reads == 0:
        raise ValueError(f"no reads found in {config.input_path}")
    return packed


def upload_bucket(bucket: PackedBucket, device: torch.device) -> PackedChunk:
    """A bucket on `device` in its 2-bit form, as `fedrann_tpu/pipeline.py`
    uploads it: the stream with the row lengths when every row's valid
    bases are a prefix (prefix_valid; popcounted when not known), else
    with the valid bits. Never the byte matrix: a bucket that holds one
    (the plain packer's, or a cache's) is bit-packed on the host first. On
    a CUDA device the copies are non_blocking from pinned memory; a host
    buffer that is not pinned (a cache's) is copied into pinned memory
    first, counted in `.pin_copies`. The bytes uploaded add to `.bytes`."""
    if bucket.packed_bases is None:
        packed, valid = bit_pack(bucket.bases)
    else:
        packed, valid = bucket.packed_bases, bucket.valid_bits
    if bucket.prefix_valid is None:
        set_bits = np.unpackbits(valid, axis=1).sum(axis=1, dtype=np.int64)
        bucket.prefix_valid = bool((set_bits == bucket.lengths).all())
    aux = (np.ascontiguousarray(bucket.lengths, dtype=np.int32)
           if bucket.prefix_valid else valid)

    def put(a: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(a))
        upload_bucket.bytes += host.numel() * host.element_size()
        if device.type != "cuda":
            return host
        if not host.is_pinned():
            host = host.pin_memory()
            upload_bucket.pin_copies += 1
        return host.to(device, non_blocking=True)

    if bucket.prefix_valid:
        return PackedChunk(put(packed), bucket.length, lengths=put(aux))
    return PackedChunk(put(packed), bucket.length, valid_bits=put(aux))


upload_bucket.bytes = 0
upload_bucket.pin_copies = 0


def chunk_rows(length: int, n_rows_total: int, config: PipelineConfig) -> int:
    """Rows per staging chunk: window_batch windows (at least 8 rows),
    capped by --chunk-size and by the bucket's own row count rounded up to
    a power of two."""
    rows = max(8, (config.window_batch // length) // 8 * 8)
    if config.chunk_size:
        rows = max(8, min(rows, config.chunk_size // 8 * 8 or 8))
    return min(rows, max(8, 1 << (max(n_rows_total, 1) - 1).bit_length()))


def staging_params(length: int, config: PipelineConfig):
    """(hit_buffer, keep_all, block_cap) for a bucket of `length` bases.
    An imported library was not sampled by our hash, so the sampling filter
    would drop its hits: it stages every valid window."""
    keep_all = (config.kmer_sample_fraction >= 1.0
                or config.import_library is not None)
    w = length - config.kmer_size + 1
    hit_buffer = w if keep_all else staging_width(
        w, config.kmer_sample_fraction)
    if config.max_hits_per_read is not None:
        hit_buffer = min(hit_buffer,
                         max(8, -(-config.max_hits_per_read // 8) * 8))
    block_cap = None if keep_all else selection_cap(
        config.kmer_sample_fraction)
    return hit_buffer, keep_all, block_cap


def stage_reads(packed: PackedReads, config: PipelineConfig,
                device: torch.device) -> list[StagedBucket]:
    """Upload every bucket in its 2-bit form (upload_bucket) and stage it
    in chunks of chunk_rows reads; the count and the embed stages both
    consume the result."""
    threshold = sample_threshold(config.kmer_sample_fraction)
    out = []
    for bucket in packed.buckets:
        n = bucket.read_index.shape[0]
        rows = chunk_rows(bucket.length, n, config)
        hit_buffer, keep_all, block_cap = staging_params(bucket.length,
                                                         config)
        bases = upload_bucket(bucket, device)
        parts = [
            stage_candidates(bases[s : s + rows], config.kmer_size,
                             hit_buffer, keep_all, config.seed, threshold,
                             block_cap)
            for s in range(0, n, rows)
        ]
        out.append(StagedBucket(
            staged=torch.cat([p[0] for p in parts]),
            dropped=torch.cat([p[1] for p in parts]),
            read_index=torch.from_numpy(
                bucket.read_index.astype(np.int64)).to(device),
            rows=rows,
        ))
    overflow = int(sum(int(b.dropped.sum()) for b in out))
    if overflow:
        logger.warning(
            "candidate staging overflowed by %d occurrences; k-mer counts "
            "may undercount duplicates on highly repetitive reads", overflow)
    return out


def build_projection(config: PipelineConfig, library: KmerLibrary,
                     perm: Optional[np.ndarray], device: torch.device):
    """The embed stage's projection, in the order of the JAX package: an
    imported projection (rows permuted by perm, the imported library's
    mapping, when there is one) as a dense float32 paired table whatever
    --projection-dtype says; else the sign table (signs, mags), or a dense
    paired table in float32 or bfloat16."""
    if config.import_projection:
        p_flat = load_reference_precompute(config.import_projection, perm)
        if p_flat.shape[0] != library.n_features + 1:
            raise ValueError(
                f"imported projection has {p_flat.shape[0] - 1} feature "
                f"rows; library needs {library.n_features}")
        logger.info("imported reference projection %s %s (paired)",
                    config.import_projection, p_flat.shape)
        return pair_projection(torch.from_numpy(p_flat)).to(device)
    if config.projection_dtype == "signs":
        return build_precompute_signs(
            library.counts, config.embedding_dimension,
            config.projection_seed, config.projection_density)
    return build_precompute_paired(
        library.counts, config.embedding_dimension, config.projection_seed,
        config.projection_density,
        dtype=(torch.float32 if config.projection_dtype == "f32"
               else torch.bfloat16))


def split_union_groups(staged: list[StagedBucket], split_ids: torch.Tensor,
                       max_slots: int) -> list[torch.Tensor]:
    """split_ids (m,) int64, sorted ascending, cut into groups whose merged
    rows (split_union_rows) hold at most max_slots slots, rows times padded
    width; a read whose own row is wider is a group of its own. Reads are
    taken in the order of their slot counts, so each group's rows are of
    like width. Returns each group's ids, sorted ascending."""
    m = split_ids.shape[0]
    per_read = torch.zeros(m, dtype=torch.int64, device=split_ids.device)
    for bucket in staged:
        mask = torch.isin(bucket.read_index, split_ids)
        # rows are sorted with PAD_SLOT last: its insertion point is the
        # row's slot count, found without a copy of the rows
        pad = torch.full((bucket.staged.shape[0], 1), PAD_SLOT,
                         dtype=torch.int64, device=bucket.staged.device)
        n = torch.searchsorted(bucket.staged, pad)[:, 0]
        per_read.index_add_(0, torch.searchsorted(
            split_ids, bucket.read_index[mask]), n[mask])
    counts = per_read.tolist()
    groups, group = [], []
    for i in sorted(range(m), key=counts.__getitem__):
        width = max(8, -(-counts[i] // 8) * 8)
        if group and (len(group) + 1) * width > max_slots:
            groups.append(group)
            group = []
        group.append(i)
    if group:
        groups.append(group)
    return [split_ids[sorted(g)] for g in groups]


def split_union_rows(staged: list[StagedBucket], split_ids: torch.Tensor):
    """The staged rows of the split reads split_ids (m,) int64, sorted
    ascending, merged: row i holds the slots of every segment of read
    split_ids[i], from every bucket, sorted ascending and padded with
    PAD_SLOT to a multiple of 8 (at least 8). Kernel C counts a slot equal
    to its left neighbour once, so each row embeds the exact union of its
    segments' distinct (code, strand) hits, as the JAX package's np.unique
    over hit indices does. Returns rows (m, W) int64."""
    rids, slots = [], []
    for bucket in staged:
        mask = torch.isin(bucket.read_index, split_ids)
        seg = bucket.staged[mask]
        rids.append(bucket.read_index[mask][:, None].expand_as(seg).reshape(-1))
        slots.append(seg.reshape(-1))
    rid, slot = torch.cat(rids), torch.cat(slots)
    keep = slot != PAD_SLOT
    row, slot = torch.searchsorted(split_ids, rid[keep]), slot[keep]
    # by (row, slot): sort the slots, then stably by row
    order = torch.sort(slot, stable=True).indices
    row, slot = row[order], slot[order]
    order = torch.sort(row, stable=True).indices
    row, slot = row[order], slot[order]
    m = split_ids.shape[0]
    per_row = torch.bincount(row, minlength=m)
    width = max(8, -(-int(per_row.max()) // 8) * 8)
    first = torch.cumsum(per_row, 0) - per_row
    col = torch.arange(slot.shape[0], device=slot.device) - first[row]
    rows = torch.full((m, width), PAD_SLOT, dtype=torch.int64,
                      device=slot.device)
    rows[row, col] = slot
    return rows


def _split_union_plain(staged: list[StagedBucket], split_ids: torch.Tensor,
                       lib_codes: torch.Tensor, proj, d: int):
    """The plain version of the split reads' union, as the JAX package
    computes it: each segment row's hits (read_hits_staged), the unique
    hits of each read of split_ids, embedded in the projection's form.
    Returns (fwd, rev) (m, d) float32."""
    lib_size = lib_codes.shape[0]
    per_read: list[list[torch.Tensor]] = [[] for _ in range(len(split_ids))]
    for bucket in staged:
        mask = torch.isin(bucket.read_index, split_ids)
        hits, _ = read_hits_staged(bucket.staged[mask], lib_codes)
        rows = torch.searchsorted(split_ids, bucket.read_index[mask])
        for r, h in zip(rows.tolist(), hits):
            per_read[r].append(h)
    unions = [u[u < 2 * lib_size] for u in
              (torch.unique(torch.cat(h)) for h in per_read)]
    width = max(8, -(-max(len(u) for u in unions) // 8) * 8)
    hit_mat = torch.full((len(unions), width), 2 * lib_size,
                         dtype=torch.int64, device=lib_codes.device)
    for r, u in enumerate(unions):
        hit_mat[r, : len(u)] = u
    return embed_hits(hit_mat, proj, lib_size, d)


class _HostRows:
    """The host output of compute_embeddings (out="host"): kernel C writes
    each chunk's fwd and rev rows into one reused (2 rows, d) float32
    device buffer at local targets; the written rows are cast to bfloat16
    on the device, copied to the host (through pinned memory on a CUDA
    device) and placed at their targets in the (2N, d) bfloat16 host
    matrix. Rows with target -1 (pad rows, split-read segments) keep the
    last chunk's values in the buffer and are never copied."""

    def __init__(self, n_reads: int, d: int, max_rows: int,
                 device: torch.device):
        self.matrix = torch.zeros((2 * n_reads, d), dtype=torch.bfloat16)
        self.buf = torch.empty((2 * max_rows, d), dtype=torch.float32,
                               device=device)
        self.pinned = (torch.empty((2 * max_rows, d), dtype=torch.bfloat16,
                                   pin_memory=True)
                       if device.type == "cuda" else None)

    def write(self, staged: torch.Tensor, targets: torch.Tensor,
              lib_codes: torch.Tensor, proj) -> None:
        """embed_staged of the staged rows (r, H) into the host matrix at
        targets (r, 2) (-1 = do not write)."""
        r, d = staged.shape[0], self.buf.shape[1]
        written = targets >= 0
        local = torch.arange(2 * r, device=targets.device).view(r, 2)
        embed_staged(staged, lib_codes, proj,
                     torch.where(written, local, -1), self.buf[: 2 * r])
        rows = self.buf[: 2 * r].to(torch.bfloat16)
        if self.pinned is not None:
            rows = self.pinned[: 2 * r].copy_(rows)
        written = written.cpu()
        self.matrix[targets.cpu()[written]] = rows.view(r, 2, d)[written]


def compute_embeddings(n_reads: int, staged: list[StagedBucket],
                       library: KmerLibrary, proj, d: int,
                       split_read_ids: Optional[np.ndarray],
                       union_slots: int, device: torch.device,
                       out: str = "device") -> torch.Tensor:
    """(2N, d) float32 embeddings in (read0_fwd, read0_rev, ...) order;
    zero-hit reads are exact zero rows. proj is the sign table (signs,
    mags) or a dense paired table (embed_staged). The segment rows of split
    reads are kept out of the per-bucket scatter (targets -1); each split
    read's rows are then the embedding of its merged segments
    (split_union_rows), through kernel C again, one launch per group of
    at most union_slots merged slots (split_union_groups).

    out="host" (the out-of-core path): the matrix is a CPU bfloat16 tensor
    filled chunk by chunk (_HostRows), and no (2N, d) device tensor
    exists."""
    split = torch.from_numpy(
        np.sort(split_read_ids).astype(np.int64) if split_read_ids is not None
        else np.zeros(0, np.int64)).to(device)
    groups = (split_union_groups(staged, split, union_slots)
              if split.numel() else [])
    if out == "host":
        sink = _HostRows(n_reads, d, max([min(b.rows, b.staged.shape[0])
                                          for b in staged]
                                         + [len(ids) for ids in groups]),
                         device)
        emb = sink.matrix

        def write(rows, targets):
            sink.write(rows, targets, library.codes, proj)
    else:
        emb = torch.zeros((2 * n_reads, d), dtype=torch.float32,
                          device=device)

        def write(rows, targets):
            embed_staged(rows, library.codes, proj, targets, emb)
    for bucket in staged:
        ri = bucket.read_index
        keep = (ri >= 0) & ~torch.isin(ri, split)
        targets = torch.stack([torch.where(keep, 2 * ri, -1),
                               torch.where(keep, 2 * ri + 1, -1)], dim=1)
        for s in range(0, ri.shape[0], bucket.rows):
            write(bucket.staged[s : s + bucket.rows],
                  targets[s : s + bucket.rows])
    for ids in groups:
        write(split_union_rows(staged, ids),
              torch.stack([2 * ids, 2 * ids + 1], dim=1))
    if groups:
        logger.info("merged %d split reads (exact hit union) in %d groups",
                    split.numel(), len(groups))
    return emb


def embed_hbm_bytes(staged: list[StagedBucket], lib_codes: torch.Tensor,
                    proj, n_reads: int, d: int) -> float:
    """The device-memory bytes kernel C must move over the embed stage's
    buckets, each read or written once (chip_smoke.py's bound for it):
    the staged int64 slots, each row's targets and hit count, the library,
    each distinct library row a slot hits (its sign words and magnitude,
    or its dense paired row), and the (2N, d) float32 output. The JAX
    package counts one table row per staged slot instead, misses and
    padding included, which reads past the card's memory rate. Runs on
    the staged rows' device, outside the stage's time."""
    dense = isinstance(proj, torch.Tensor)
    table = proj if dense else proj[0]
    row_bytes = table.shape[1] * table.element_size() + (0 if dense else 4)
    lib_size = lib_codes.shape[0]
    seen = torch.zeros(lib_size, dtype=torch.bool, device=lib_codes.device)
    slots = rows = 0
    for bucket in staged:
        for s in range(0, bucket.staged.shape[0], bucket.rows):
            hits, _ = read_hits_staged(bucket.staged[s : s + bucket.rows],
                                       lib_codes)
            hits = hits[hits < 2 * lib_size]
            seen[torch.where(hits >= lib_size, hits - lib_size, hits)] = True
        slots += bucket.staged.numel()
        rows += bucket.staged.shape[0]
    return (8.0 * slots + 20.0 * rows + 8.0 * lib_size
            + float(seen.sum()) * row_bytes + 2.0 * n_reads * d * 4)


def add_knn_work(metrics: StageMetrics, query_rows: int,
                 candidate_rows: int, d: int, idx: np.ndarray,
                 transfer: str, device: torch.device,
                 share: float = 1.0) -> None:
    """The k-NN's work: 2 * queries * candidates * d distance operations
    times `share` (ivf_share), and the neighbor matrices brought to the
    host from the search's `device` (topk.d2h_entry_bytes an entry: K10's
    8 from a card, the JAX package's `elem + idx_elem` elsewhere)."""
    metrics.add_work("knn",
                     flops=2.0 * query_rows * candidate_rows * d * share,
                     d2h_bytes=float(idx.shape[0] * idx.shape[1]
                                     * d2h_entry_bytes(transfer,
                                                       candidate_rows,
                                                       device)))


def ivf_share(config: PipelineConfig, n_rows: int) -> float:
    """The share of the exact search's distance operations the JAX package
    counts for a run: min(1, p / C) under --knn-method ivf, C the
    --knn-ivf-clusters or auto_clusters(N); 1 otherwise."""
    if config.knn_method != "ivf":
        return 1.0
    c_eff = config.knn_ivf_clusters or auto_clusters(n_rows)
    return min(1.0, config.knn_ivf_probes / max(c_eff, 1))


def search(config: PipelineConfig, emb: torch.Tensor, ooc: bool,
           use_mesh: bool, mesh: Sequence[torch.device],
           device: torch.device, metrics: StageMetrics):
    """The k-NN of run_pipeline, routed as the JAX package routes it: out
    of core, knn_ivf_ooc (--knn-method ivf) or knn_exact_ooc on `device`
    (a mesh is overridden, with a warning); else IVF on one device
    (knn_ivf) or over a 1-D mesh of `mesh` (knn_ivf_sharded); else the
    exact search sharded over knn_mesh (knn_exact_sharded) or on one
    device (knn_exact). Returns (indices, distances). The call is the span
    "fedrann.search" (metrics.span) on every route."""
    with span("fedrann.search"):
        ivf = config.knn_method == "ivf"
        ivf_args = dict(n_clusters=config.knn_ivf_clusters,
                        n_probes=config.knn_ivf_probes,
                        spill=config.knn_ivf_spill)
        if ooc:
            if use_mesh:
                logger.warning(
                    "out-of-core k-NN streams through one device; "
                    "mesh sharding is overridden past the HBM budget")
            fn = knn_ivf_ooc if ivf else knn_exact_ooc
            before = fn.h2d_bytes
            out = fn(emb, config.n_neighbors, config.knn_hbm_budget,
                     query_tile=config.knn_query_tile,
                     candidate_tile=config.knn_candidate_tile,
                     precision=config.knn_precision,
                     transfer=config.knn_transfer, device=device,
                     **(ivf_args if ivf else {}))
            metrics.add_work("knn", h2d_bytes=fn.h2d_bytes - before)
            return out
        if ivf and not use_mesh:
            return knn_ivf(emb, config.n_neighbors,
                           precision=config.knn_precision,
                           transfer=config.knn_transfer, **ivf_args)
        if ivf:
            knn = make_mesh(config.mesh_shape, mesh)
            logger.info("IVF k-NN sharded over %d devices", knn.size)
            return knn_ivf_sharded(emb, config.n_neighbors, mesh=knn,
                                   precision=config.knn_precision,
                                   transfer=config.knn_transfer, **ivf_args)
        if use_mesh:
            knn = knn_mesh(config, mesh)
            logger.info("k-NN sharded over %d devices (%s)", knn.size,
                        config.knn_shard_strategy)
            return knn_exact_sharded(
                emb, config.n_neighbors, mesh=knn,
                strategy=config.knn_shard_strategy,
                precision=config.knn_precision, transfer=config.knn_transfer,
                candidate_tile=config.knn_candidate_tile,
                query_tile=config.knn_query_tile)
        return knn_exact(emb, config.n_neighbors,
                         query_tile=config.knn_query_tile,
                         candidate_tile=config.knn_candidate_tile,
                         precision=config.knn_precision,
                         transfer=config.knn_transfer)


def _input_identity(config: PipelineConfig) -> dict:
    """Identity of the input (path, size, mtime): a checkpoint does not
    survive a changed input."""
    try:
        st = os.stat(config.input_path)
        return {"path": os.path.abspath(config.input_path),
                "size": st.st_size, "mtime_ns": st.st_mtime_ns}
    except OSError:
        return {"path": os.path.abspath(config.input_path)}


def _embed_fingerprint(config: PipelineConfig, packed: PackedReads,
                       library: KmerLibrary) -> dict:
    """Everything the embedding matrix depends on, as the JAX package
    writes it to embeddings_meta.json."""
    return {
        "input": _input_identity(config),
        "k": config.kmer_size,
        "seed": config.seed,
        "fraction": config.kmer_sample_fraction,
        "min_multiplicity": config.kmer_min_multiplicity,
        "dim": config.embedding_dimension,
        "projection_seed": config.projection_seed,
        "projection_density": config.projection_density,
        "projection_dtype": config.projection_dtype,
        "import_library": config.import_library,
        "import_projection": config.import_projection,
        "max_hits": config.max_hits_per_read,
        "n_reads": packed.n_reads,
        "library_size": library.size,
    }


def _load_embeddings_checkpoint(config: PipelineConfig,
                                ckpt_dir: Optional[str], packed: PackedReads,
                                library: KmerLibrary, device: torch.device,
                                host: bool = False):
    """The saved embedding matrix when a run saved it under an equal
    fingerprint, else None: float32 on `device`, or as saved in host
    memory when `host` (the out-of-core path). The file holds float32, or
    2-byte elements, the bfloat16 bits of an out-of-core run (the JAX
    package's ml_dtypes file, which numpy reads as |V2)."""
    if not ckpt_dir:
        return None
    npy = os.path.join(ckpt_dir, "embeddings.npy")
    meta_path = os.path.join(ckpt_dir, "embeddings_meta.json")
    if not (os.path.exists(npy) and os.path.exists(meta_path)):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    if meta != _embed_fingerprint(config, packed, library):
        return None
    logger.info("resuming embeddings from %s", npy)
    arr = np.load(npy)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        emb = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        emb = torch.from_numpy(arr.astype(np.float32, copy=False))
    return emb if host else emb.to(device, torch.float32)


def _host_array(emb: torch.Tensor) -> np.ndarray:
    """The matrix as numpy: float32, or a bfloat16 matrix's 2-byte
    elements (numpy has no bfloat16)."""
    if emb.dtype == torch.bfloat16:
        return emb.view(torch.int16).numpy().view("V2")
    return emb.cpu().numpy()


def _save_embeddings_checkpoint(config: PipelineConfig, ckpt_dir: str,
                                packed: PackedReads, library: KmerLibrary,
                                emb: torch.Tensor) -> None:
    """embeddings.npy: float32, or an out-of-core run's bfloat16 bits under
    the header the JAX package's ml_dtypes array gets ('<V2'), so the two
    packages write the same bytes."""
    path = os.path.join(ckpt_dir, "embeddings.npy")
    if emb.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": tuple(emb.shape)})
            f.write(emb.contiguous().view(torch.int16).numpy().tobytes())
    else:
        np.save(path, emb.cpu().numpy())
    with open(os.path.join(ckpt_dir, "embeddings_meta.json"), "w") as f:
        json.dump(_embed_fingerprint(config, packed, library), f)


def _try_load_library_ckpt(config: PipelineConfig, ckpt_dir: Optional[str],
                           device: torch.device) -> Optional[KmerLibrary]:
    """The library of checkpoints/library.npz when its k, seed, fraction,
    min multiplicity and input identity are this run's, else None."""
    if not ckpt_dir:
        return None
    path = os.path.join(ckpt_dir, "library.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)
    if (int(data["k"]) == config.kmer_size
            and int(data["seed"]) == config.seed
            and float(data["fraction"]) == config.kmer_sample_fraction
            and int(data.get("min_multiplicity", -1))
            == config.kmer_min_multiplicity
            and str(data.get("input_id", ""))
            == json.dumps(_input_identity(config), sort_keys=True)):
        logger.info("resuming library from %s", path)
        return KmerLibrary(
            codes=torch.from_numpy(data["codes"].astype(np.int64)).to(device),
            counts=torch.from_numpy(
                data["counts"].astype(np.int64)).to(device))
    return None


def _save_library_ckpt(config: PipelineConfig, ckpt_dir: str,
                       library: KmerLibrary) -> None:
    """checkpoints/library.npz in the JAX package's keys and dtypes (codes
    uint64, counts int64)."""
    codes, counts = library.numpy()
    np.savez(os.path.join(ckpt_dir, "library.npz"), codes=codes,
             counts=counts, k=config.kmer_size, seed=config.seed,
             fraction=config.kmer_sample_fraction,
             min_multiplicity=config.kmer_min_multiplicity,
             input_id=json.dumps(_input_identity(config), sort_keys=True))


def _load_or_build_library(config: PipelineConfig, ckpt_dir: Optional[str],
                           get_staged, device: torch.device):
    """(library, perm): an imported library with its mapping; else a
    library checkpoint; else the library built from the staged slots
    (get_staged() stages on first call), saved when checkpointing."""
    if config.import_library:
        library, perm = load_reference_library_mapping(
            config.import_library, config.kmer_size)
        logger.info("imported reference library %s", config.import_library)
        return KmerLibrary(codes=library.codes.to(device),
                           counts=library.counts.to(device)), perm
    library = _try_load_library_ckpt(config, ckpt_dir, device)
    if library is None:
        library = build_library(
            [b.staged for b in get_staged()], config.kmer_min_multiplicity,
            config.kmer_sample_fraction, config.seed)
        if ckpt_dir:
            _save_library_ckpt(config, ckpt_dir, library)
    return library, None


def _start_profiler(device: torch.device):
    """--profile: torch.profiler over the whole run (CPU and, on a CUDA
    device, CUDA activity), the counterpart of jax.profiler.trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    span.ranges = True  # the program's spans are ranges of this trace
    return prof


def run_pipeline(config: PipelineConfig, device: torch.device,
                 mesh: Optional[Sequence[torch.device]] = None
                 ) -> PipelineResult:
    """Run the pipeline on `device`. `mesh` is the devices the k-NN may
    shard over (knn_mesh): by default every visible card on a CUDA run and
    `device` alone on a CPU run."""
    if config.knn_topk_method == "approx":
        logger.info("--knn-topk-method approx runs exact selection here")
    set_logging_level(config.log_level)
    out_dir = config.output_dir
    log_handler = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        log_handler = add_log_file(os.path.join(out_dir, "fedrann.log"))
    metrics = StageMetrics(device)
    sampler = (MemorySampler(os.path.join(out_dir or ".", "mprof.dat"))
               if config.mprof else None)
    ckpt_dir = (os.path.join(out_dir, "checkpoints")
                if config.checkpoint and out_dir else None)
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
    profiler = (_start_profiler(device) if config.profile and out_dir
                else None)
    if sampler:
        sampler.__enter__()
    overlaps_path = None
    try:
        with metrics.stage("load"):
            packed = load_reads(config, device)
            logger.info("loaded %d reads into %d buckets",
                        packed.n_reads, len(packed.buckets))
        # decided before embed: past the budget the (2R, d) device matrix
        # must never exist, so embed fills a host matrix
        ooc = out_of_core(config, packed.n_reads)
        if ooc:
            logger.info(
                "embedding matrix %.2f GB + search copy exceeds the %.2f GB "
                "HBM budget: out-of-core path (host-resident matrix, "
                "streamed k-NN)",
                2 * packed.n_reads * config.embedding_dimension * 4 / 1e9,
                config.knn_hbm_budget / 1e9)
        # staged lazily, once: a run resumed from both checkpoints skips it
        staged_once: list = []

        def get_staged():
            if not staged_once:
                with metrics.stage("stage"):
                    before = upload_bucket.bytes
                    staged_once.append(stage_reads(packed, config, device))
                    metrics.add_work("stage",
                                     h2d_bytes=upload_bucket.bytes - before)
            return staged_once[0]

        with metrics.stage("count"):
            library, perm = _load_or_build_library(config, ckpt_dir,
                                                   get_staged, device)
            logger.info("library: %d canonical k-mers (%d features)",
                        library.size, library.n_features)
            if library.size == 0:
                raise ValueError(
                    "k-mer library is empty: no k-mer passed the "
                    "multiplicity/sampling filters (lower "
                    "--kmer-min-multiplicity or raise "
                    "--kmer-sample-fraction)")
        with metrics.stage("project"):
            proj = build_projection(config, library, perm, device)
        with metrics.stage("embed"):
            emb = _load_embeddings_checkpoint(config, ckpt_dir, packed,
                                              library, device, host=ooc)
            embedded = emb is None
            if embedded:
                d = projection_width(proj, config.embedding_dimension)
                emb = compute_embeddings(
                    packed.n_reads, get_staged(), library, proj, d,
                    packed.split_read_ids, config.window_batch, device,
                    out="host" if ooc else "device")
                if ckpt_dir:
                    _save_embeddings_checkpoint(config, ckpt_dir, packed,
                                                library, emb)
        if embedded:
            metrics.add_work("embed", hbm_bytes=embed_hbm_bytes(
                get_staged(), library.codes, proj, packed.n_reads, d))
        staged_once.clear()  # the staged rows and the projection go
        del proj
        with metrics.stage("knn"):
            if mesh is None:
                mesh = (make_mesh().devices if device.type == "cuda"
                        else [device])
            use_mesh = (config.knn_sharded == "always"
                        or (config.knn_sharded == "auto" and len(mesh) > 1))
            idx, dist = search(config, emb, ooc, use_mesh, mesh, device,
                               metrics)
            add_knn_work(metrics, emb.shape[0], emb.shape[0], emb.shape[1],
                         idx, config.knn_transfer, device,
                         ivf_share(config, emb.shape[0]))
        with metrics.stage("output"):
            if out_dir:
                overlaps_path = os.path.join(out_dir, "overlaps.tsv")
                n_rows = write_overlaps_path(overlaps_path, packed.names,
                                             idx, dist)
                logger.info("wrote %d overlap rows to %s", n_rows,
                            overlaps_path)
                if config.save_feature_matrix:
                    np.savez_compressed(
                        os.path.join(out_dir, "feature_matrix.npz"),
                        embeddings=_host_array(emb),
                        names=np.array(packed.names))
    finally:
        if sampler:
            sampler.__exit__(None, None, None)
        if profiler is not None:
            span.ranges = False
            profiler.__exit__(None, None, None)
            os.makedirs(os.path.join(out_dir, "trace"), exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(out_dir, "trace", "trace.json"))
        if log_handler is not None:
            remove_log_file(log_handler)
    summary = metrics.summary()
    if out_dir:
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return PipelineResult(
        names=packed.names, library=library, embeddings=emb,
        neighbor_indices=idx, neighbor_distances=dist, metrics=summary,
        overlaps_path=overlaps_path,
    )
