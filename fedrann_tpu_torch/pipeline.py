"""Pipeline orchestrator: FASTX in, overlaps.tsv out (the port of
`fedrann_tpu/pipeline.py` `run_pipeline` for the default single-device run).

Stages, as named in metrics.json:
  load    - FASTX parse and pack into length buckets (host, numpy)
  stage   - per-read canonical windows, sampling filter, candidate
            selection and row sort (kernels A and B), chunked by window_batch
  count   - library build from the staged slots (sort, run lengths,
            multiplicity and sampling filters)
  project - sign-packed SRP x ICF table
  embed   - membership + paired embedding into the (2N, d) matrix (kernel C)
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

from fedrann_tpu_torch.config import PipelineConfig
from fedrann_tpu_torch.io.fastx import read_fastx
from fedrann_tpu_torch.io.packing import PackedReads, pack_reads
from fedrann_tpu_torch.io.tsv import write_overlaps_path
from fedrann_tpu_torch.kmers.codec import sample_threshold
from fedrann_tpu_torch.kmers.library import KmerLibrary, build_library
from fedrann_tpu_torch.kmers.membership import (
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
from fedrann_tpu_torch.project.embed import membership_embed
from fedrann_tpu_torch.project.srp import build_precompute_signs


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
        (bool(config.import_library or config.import_projection),
         "--import-library/--import-projection", "imports"),
        (config.keep_intermediates or config.checkpoint,
         "--keep-intermediates", "checkpoints"),
        (config.projection_dtype != "signs",
         f"--projection-dtype {config.projection_dtype}",
         "bf16/f32 projections"),
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
    packed = pack_reads(read_fastx(config.input_path), config.length_buckets)
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
    """(hit_buffer, keep_all, block_cap) for a bucket of `length` bases."""
    keep_all = config.kmer_sample_fraction >= 1.0
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


def compute_embeddings(n_reads: int, staged: list[StagedBucket],
                       library: KmerLibrary, signs: torch.Tensor,
                       mags: torch.Tensor, d: int,
                       device: torch.device) -> torch.Tensor:
    """(2N, d) float32 embeddings in (read0_fwd, read0_rev, ...) order;
    zero-hit reads are exact zero rows."""
    emb = torch.zeros((2 * n_reads, d), dtype=torch.float32, device=device)
    for bucket in staged:
        ri = bucket.read_index
        targets = torch.stack(
            [torch.where(ri >= 0, 2 * ri, -1),
             torch.where(ri >= 0, 2 * ri + 1, -1)], dim=1)
        for s in range(0, ri.shape[0], bucket.rows):
            membership_embed(bucket.staged[s : s + bucket.rows],
                             library.codes, signs, mags,
                             targets[s : s + bucket.rows], emb)
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
            signs, mags = build_precompute_signs(
                library.counts, config.embedding_dimension,
                config.projection_seed, config.projection_density)
        with metrics.stage("embed"):
            emb = compute_embeddings(packed.n_reads, staged, library, signs,
                                     mags, config.embedding_dimension,
                                     device)
        del staged, signs, mags
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
