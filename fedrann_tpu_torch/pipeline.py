"""Pipeline orchestrator: FASTX in, overlaps.tsv out (the port of
`fedrann_tpu/pipeline.py` `run_pipeline` for the single-device run).

Stages, as named in metrics.json:
  load    - FASTX parse and pack into length buckets (host, numpy); reads
            past the largest bucket split into k - 1-overlapped segments
  stage   - per-read canonical windows, sampling filter, candidate
            selection and row sort (kernels A and B), chunked by window_batch
  count   - library build from the staged slots (sort, run lengths,
            multiplicity and sampling filters), or --import-library
  project - sign-packed SRP x ICF table, a dense paired table
            (--projection-dtype f32|bf16), or --import-projection
  embed   - membership + paired embedding into the (2N, d) matrix (kernel
            C, in the projection's form), then each split read's union
  knn     - exact cosine top-k
  output  - overlaps.tsv
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from fedrann_tpu_torch.compat import (
    load_reference_library_mapping,
    load_reference_precompute,
)
from fedrann_tpu_torch.config import PipelineConfig
from fedrann_tpu_torch.io.fastx import read_fastx
from fedrann_tpu_torch.io.packing import PackedReads, pack_reads
from fedrann_tpu_torch.io.tsv import write_overlaps_path
from fedrann_tpu_torch.kmers.codec import PAD_SLOT, sample_threshold
from fedrann_tpu_torch.kmers.library import KmerLibrary, build_library
from fedrann_tpu_torch.kmers.membership import (
    read_hits_staged,
    selection_cap,
    stage_candidates,
    staging_width,
)
from fedrann_tpu_torch.knn.topk import knn_exact
from fedrann_tpu_torch.logging_utils import (
    add_log_file,
    logger,
    remove_log_file,
    set_logging_level,
)
from fedrann_tpu_torch.metrics import StageMetrics
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
    embeddings: torch.Tensor        # (2R, d) float32, fwd/rev interleaved
    neighbor_indices: np.ndarray    # (2R, k) int32
    neighbor_distances: np.ndarray  # (2R, k) float32
    metrics: dict
    overlaps_path: Optional[str] = None


@dataclasses.dataclass
class StagedBucket:
    """One length bucket's staged candidates, on the run's device."""

    staged: torch.Tensor      # (R_b, width) int64 slots, sorted per row
    dropped: torch.Tensor     # (R_b,) int32 occurrences beyond the buffer
    read_index: torch.Tensor  # (R_b,) int64 global read index, -1 = pad row
    rows: int                 # rows per device chunk


def check_supported(config: PipelineConfig) -> None:
    """Raise NotImplementedError for options outside the ported slice,
    naming the ROADMAP Queue 1 item that brings them."""
    unsupported = [
        (config.knn_method == "ivf", "--knn-method ivf", "IVF"),
        (config.knn_hbm_budget is not None, "--knn-hbm-budget",
         "out-of-core k-NN"),
        ((config.num_processes or 0) > 1 or bool(config.coordinator),
         "--num-processes/--coordinator", "multi-host runtime"),
        (config.knn_sharded == "always" or config.mesh_shape is not None,
         "--knn-sharded always/--mesh-shape", "multi-GPU k-NN"),
        (config.keep_intermediates or config.checkpoint,
         "--keep-intermediates", "checkpoints"),
        (config.profile, "--profile", "profiling"),
        (config.save_feature_matrix, "--save-feature-matrix",
         "feature-matrix output"),
        (config.mprof, "--mprof", "memory timeline"),
    ]
    for bad, flag, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported to fedrann_tpu_torch yet "
                f"(ROADMAP Queue 1: {item})")


def load_reads(config: PipelineConfig) -> PackedReads:
    """Pack the input; a read past the largest bucket is split into
    segments overlapping by k - 1 bases."""
    packed = pack_reads(read_fastx(config.input_path), config.length_buckets,
                        split_overlap=config.kmer_size - 1)
    if packed.n_reads == 0:
        raise ValueError(f"no reads found in {config.input_path}")
    return packed


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
    """Stage every bucket in chunks of chunk_rows reads; the count and the
    embed stages both consume the result."""
    threshold = sample_threshold(config.kmer_sample_fraction)
    out = []
    for bucket in packed.buckets:
        n = bucket.bases.shape[0]
        rows = chunk_rows(bucket.length, n, config)
        hit_buffer, keep_all, block_cap = staging_params(bucket.length,
                                                         config)
        bases = torch.from_numpy(bucket.bases).to(device)
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


def compute_embeddings(n_reads: int, staged: list[StagedBucket],
                       library: KmerLibrary, proj, d: int,
                       split_read_ids: Optional[np.ndarray],
                       union_slots: int,
                       device: torch.device) -> torch.Tensor:
    """(2N, d) float32 embeddings in (read0_fwd, read0_rev, ...) order;
    zero-hit reads are exact zero rows. proj is the sign table (signs,
    mags) or a dense paired table (embed_staged). The segment rows of split
    reads are kept out of the per-bucket scatter (targets -1); each split
    read's rows are then the embedding of its merged segments
    (split_union_rows), through kernel C again, one launch per group of
    at most union_slots merged slots (split_union_groups)."""
    emb = torch.zeros((2 * n_reads, d), dtype=torch.float32, device=device)
    split = torch.from_numpy(
        np.sort(split_read_ids).astype(np.int64) if split_read_ids is not None
        else np.zeros(0, np.int64)).to(device)
    for bucket in staged:
        ri = bucket.read_index
        keep = (ri >= 0) & ~torch.isin(ri, split)
        targets = torch.stack([torch.where(keep, 2 * ri, -1),
                               torch.where(keep, 2 * ri + 1, -1)], dim=1)
        for s in range(0, ri.shape[0], bucket.rows):
            embed_staged(bucket.staged[s : s + bucket.rows], library.codes,
                         proj, targets[s : s + bucket.rows], emb)
    if split.numel():
        groups = split_union_groups(staged, split, union_slots)
        for ids in groups:
            embed_staged(split_union_rows(staged, ids), library.codes, proj,
                         torch.stack([2 * ids, 2 * ids + 1], dim=1), emb)
        logger.info("merged %d split reads (exact hit union) in %d groups",
                    split.numel(), len(groups))
    return emb


def run_pipeline(config: PipelineConfig,
                 device: torch.device) -> PipelineResult:
    check_supported(config)
    if config.knn_topk_method == "approx":
        logger.info("--knn-topk-method approx runs exact selection here")
    set_logging_level(config.log_level)
    out_dir = config.output_dir
    log_handler = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        log_handler = add_log_file(os.path.join(out_dir, "fedrann.log"))
    metrics = StageMetrics(device)
    overlaps_path = None
    try:
        with metrics.stage("load"):
            packed = load_reads(config)
            logger.info("loaded %d reads into %d buckets",
                        packed.n_reads, len(packed.buckets))
        with metrics.stage("stage"):
            staged = stage_reads(packed, config, device)
        with metrics.stage("count"):
            perm = None
            if config.import_library:
                library, perm = load_reference_library_mapping(
                    config.import_library, config.kmer_size)
                library = KmerLibrary(codes=library.codes.to(device),
                                      counts=library.counts.to(device))
                logger.info("imported reference library %s",
                            config.import_library)
            else:
                library = build_library(
                    [b.staged for b in staged], config.kmer_min_multiplicity,
                    config.kmer_sample_fraction, config.seed)
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
            emb = compute_embeddings(
                packed.n_reads, staged, library, proj,
                projection_width(proj, config.embedding_dimension),
                packed.split_read_ids, config.window_batch, device)
        del staged, proj
        with metrics.stage("knn"):
            idx, dist = knn_exact(
                emb, config.n_neighbors,
                query_tile=config.knn_query_tile,
                candidate_tile=config.knn_candidate_tile,
                precision=config.knn_precision,
                transfer=config.knn_transfer,
            )
        with metrics.stage("output"):
            if out_dir:
                overlaps_path = os.path.join(out_dir, "overlaps.tsv")
                n_rows = write_overlaps_path(overlaps_path, packed.names,
                                             idx, dist)
                logger.info("wrote %d overlap rows to %s", n_rows,
                            overlaps_path)
    finally:
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
