"""Multi-process runtime: one process per host (or card set), reads
partitioned by contiguous ranges (the port of
`fedrann_tpu/parallel/runtime.py`).

Launch N processes of `python -m fedrann_tpu_torch ... --num-processes N
--process-id r --coordinator host:port` (or JAX_COORDINATOR_ADDRESS).
Each rank owns reads [start, end) = host_read_range(...), hence global
embedding rows [2 * start, 2 * end), and:
- loads them: rank 0 parses and saves <out>/fxcache.npz, the others load
  it after a barrier; without a shared cache each rank scans its byte
  share of a plain FASTA for record starts, all-gathers them and parses
  only its own records; otherwise it parses the whole file and keeps its
  range;
- stages its reads (kernels A and B, fused where a row fits one block) and
  builds its library shard at min_multiplicity 1; the shards are
  all-gathered and merged, and the global multiplicity filter applied, so
  every rank holds the single-process library bitwise;
- builds the projection from the seed and embeds its rows (kernel C);
- searches its rows over every rank's rows: with --knn-method ivf the
  IVF search over all ranks' cards (knn/ivf.py
  knn_ivf_sharded_multihost), else the sharded exact search over them
  (knn/ring.py knn_exact_sharded_multihost; ring, allgather or ring2d by
  --knn-shard-strategy, or FEDRANN_TPU_MULTIHOST_KNN); with
  FEDRANN_TPU_MULTIHOST_KNN=host (either method) the rows all-gathered to
  every rank and searched exactly with knn_exact_block;
- writes its rows to overlaps.rank<r>.tsv (global row numbers), then rank
  0 concatenates the rank tables into overlaps.tsv between two barriers.
Each rank writes metrics.rank<r>.json, and with the flags mprof.rank<r>.dat,
feature_matrix.rank<r>.npz and checkpoints/embeddings.rank<r>.npy.

With one process `run_pipeline_multihost` is `pipeline.run_pipeline`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from fedrann_tpu_torch import pipeline
from fedrann_tpu_torch.config import PipelineConfig
from fedrann_tpu_torch.io.cache import (
    cache_meta,
    load_packed_cache,
    save_packed_cache,
)
from fedrann_tpu_torch.io.native import (
    host_zeros,
    is_plain_fasta,
    pack_reads_native,
    scan_records_native,
)
from fedrann_tpu_torch.io.packing import PackedBucket, PackedReads
from fedrann_tpu_torch.io.tsv import HEADER, write_overlaps_path
from fedrann_tpu_torch.kmers.library import KmerLibrary, build_library
from fedrann_tpu_torch.knn.ivf import knn_ivf_sharded_multihost
from fedrann_tpu_torch.knn.ring import knn_exact_sharded_multihost
from fedrann_tpu_torch.knn.topk import knn_exact_block, normalize_rows
from fedrann_tpu_torch.logging_utils import logger, set_logging_level
from fedrann_tpu_torch.metrics import MemorySampler, StageMetrics
from fedrann_tpu_torch.parallel.dist import (
    DeviceTransport,
    ProcessGroup,
    initialize_distributed,
    shutdown,
)
from fedrann_tpu_torch.parallel.mesh import make_mesh
from fedrann_tpu_torch.project.embed import projection_width

MULTIHOST_KNN_ENV = "FEDRANN_TPU_MULTIHOST_KNN"


def process_quota(n_reads: int, num_processes: int,
                  row_multiple: int = 1) -> int:
    """The uniform per-process read quota `per`, rounded up so 2 * per
    rows divide over row_multiple local devices. Interior processes stay
    full, so global row 2g belongs to read g and every padding row sits at
    the global tail."""
    per = -(-n_reads // num_processes)
    if row_multiple > 1:
        # the smallest step keeping 2 * per % row_multiple == 0
        half = (row_multiple // 2 if row_multiple % 2 == 0
                else row_multiple)
        per = -(-per // half) * half
    return per


def host_read_range(n_reads: int, process_id: int, num_processes: int,
                    row_multiple: int = 1) -> tuple[int, int]:
    """The contiguous reads [start, end) a process owns (process_quota)."""
    per = process_quota(n_reads, num_processes, row_multiple)
    start = min(process_id * per, n_reads)
    return start, min(start + per, n_reads)


def merge_library_shards(shards: list[KmerLibrary]) -> KmerLibrary:
    """The union of per-process libraries with their counts summed (codes
    sorted). A code sampled on one process is sampled on every process
    that sees it: the hash depends on the code alone."""
    if len(shards) == 1:
        return shards[0]
    parts = [s.numpy() for s in shards]
    codes = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    order = np.argsort(codes, kind="stable")
    codes, counts = codes[order], counts[order]
    boundary = np.concatenate([[True], codes[1:] != codes[:-1]])
    seg = np.cumsum(boundary) - 1
    uniq = codes[boundary]
    merged = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(merged, seg, counts)
    device = shards[0].codes.device
    return KmerLibrary(
        codes=torch.from_numpy(uniq.astype(np.int64)).to(device),
        counts=torch.from_numpy(merged).to(device))


def partition_counts_threshold(shards: list[KmerLibrary],
                               min_multiplicity: int) -> KmerLibrary:
    """The global multiplicity filter over shards built at
    min_multiplicity 1: counts summed, then the threshold, which gives
    the library one process builds over all reads, bitwise."""
    merged = merge_library_shards(shards)
    keep = merged.counts >= min_multiplicity
    return KmerLibrary(codes=merged.codes[keep], counts=merged.counts[keep])


def allgather_library(group: ProcessGroup, local: KmerLibrary,
                      min_multiplicity: int) -> KmerLibrary:
    """Every process's shard (min_multiplicity 1) gathered over the host
    group and merged under the global threshold; one process: the
    threshold alone."""
    if group.size == 1:
        return partition_counts_threshold([local], min_multiplicity)
    codes, counts = local.numpy()
    all_codes = group.allgather_ragged(codes.astype(np.int64))
    all_counts = group.allgather_ragged(counts)
    device = local.codes.device
    shards = [KmerLibrary(codes=torch.from_numpy(c).to(device),
                          counts=torch.from_numpy(n).to(device))
              for c, n in zip(all_codes, all_counts)]
    return partition_counts_threshold(shards, min_multiplicity)


def _parse_full(config: PipelineConfig) -> PackedReads:
    """The whole input parsed and packed, as one process loads it."""
    return pack_reads_native(config.input_path, config.length_buckets,
                             threads=max(1, config.threads),
                             split_overlap=config.kmer_size - 1)


def _pack_input_shared(config: PipelineConfig,
                       group: ProcessGroup) -> Optional[PackedReads]:
    """The input parsed once per shared filesystem: rank 0 packs it and
    saves <out>/fxcache.npz, the other ranks load that after a barrier.
    None where there is no usable shared cache (--no-pack-cache, no
    output dir, or an output dir the ranks do not share)."""
    if not (config.pack_cache and config.output_dir):
        return None
    cache_path = os.path.join(config.output_dir, "fxcache.npz")
    meta = cache_meta(config.input_path, config.length_buckets,
                      config.kmer_size - 1)
    packed = load_packed_cache(cache_path, meta)
    if packed is None and group.rank == 0:
        os.makedirs(config.output_dir, exist_ok=True)
        packed = _parse_full(config)
        save_packed_cache(cache_path, packed, meta)
    # every rank passes this barrier exactly once, cache hit or miss
    group.barrier("fxcache")
    if packed is None:
        packed = load_packed_cache(cache_path, meta)
        if packed is None:
            logger.info("[rank %d] fxcache not visible after barrier",
                        group.rank)
    return packed


def _pack_input_ranged(config: PipelineConfig, group: ProcessGroup,
                       row_multiple: int, pin_memory: bool):
    """The byte-range load of a plain FASTA: each rank scans its 1/size
    share of the file for record starts, the offsets and names are
    all-gathered, and each rank parses only the bytes of its own records.
    Returns (local PackedReads, global names, n_reads, start, end), or
    None for an input that is not a plain FASTA."""
    path = config.input_path
    if not is_plain_fasta(path):
        return None
    size = os.path.getsize(path)
    lo = group.rank * size // group.size
    hi = (group.rank + 1) * size // group.size
    names_local, offs_local = scan_records_native(path, lo, hi)
    all_offs = group.allgather_ragged(offs_local)
    blob = "\n".join(names_local).encode("latin-1")
    all_blobs = group.allgather_ragged(np.frombuffer(blob, np.uint8))
    names_global: list[str] = []
    for offs, raw in zip(all_offs, all_blobs):
        if len(offs):
            names_global.extend(bytes(raw).decode("latin-1").split("\n"))
    n_reads = len(names_global)
    if n_reads == 0:
        raise ValueError(f"no reads found in {path}")
    rec_offsets = np.concatenate(all_offs)
    start, end = host_read_range(n_reads, group.rank, group.size,
                                 row_multiple)
    byte_lo = int(rec_offsets[start]) if start < n_reads else size
    byte_hi = int(rec_offsets[end]) if end < n_reads else size
    logger.info("[rank %d] byte-range parse: records [%d, %d) = file bytes "
                "[%d, %d) (%.1f%% of input)", group.rank, start, end,
                byte_lo, byte_hi, 100.0 * (byte_hi - byte_lo) / max(size, 1))
    local = pack_reads_native(path, config.length_buckets,
                              threads=max(1, config.threads),
                              split_overlap=config.kmer_size - 1,
                              pin_memory=pin_memory,
                              byte_range=(byte_lo, byte_hi))
    return local, names_global, n_reads, start, end


def _local_slice(packed_all: PackedReads, start: int, end: int,
                 pin_memory: bool = False) -> PackedReads:
    """The reads [start, end) of packed_all with local read indices (names
    sliced to the range). A split read's segments follow it, and
    split_read_ids are re-based, so the embed stage merges them as one
    process does. Bit-packed buckets are sliced plane by plane (into
    pinned memory when pin_memory); zero-filled pad rows decode as
    invalid."""
    local = PackedReads(names=packed_all.names[start:end], buckets=[])
    if packed_all.split_read_ids is not None:
        ids = np.asarray(packed_all.split_read_ids)
        sel = ids[(ids >= start) & (ids < end)] - start
        local.split_read_ids = sel.astype(np.int32) if len(sel) else None
    for b in packed_all.buckets:
        mask = (b.read_index >= start) & (b.read_index < end)
        if not mask.any():
            continue
        rows = np.flatnonzero(mask)
        pad = -(-len(rows) // 8) * 8
        idx = np.full(pad, -1, dtype=np.int32)
        idx[: len(rows)] = b.read_index[rows] - start
        lengths = host_zeros(pad, np.int32, pin_memory)
        lengths[: len(rows)] = b.lengths[rows]
        if b.bases is None:
            pk = host_zeros((pad, b.packed_bases.shape[1]), np.uint8,
                            pin_memory)
            pk[: len(rows)] = b.packed_bases[rows]
            vd = host_zeros((pad, b.valid_bits.shape[1]), np.uint8,
                            pin_memory)
            vd[: len(rows)] = b.valid_bits[rows]
            local.buckets.append(PackedBucket(
                bases=None, lengths=lengths, read_index=idx,
                packed_bases=pk, valid_bits=vd, length=b.length,
                prefix_valid=b.prefix_valid))
            continue
        bases = np.full((pad, b.bases.shape[1]), 4, dtype=np.uint8)
        bases[: len(rows)] = b.bases[rows]
        local.buckets.append(PackedBucket(
            bases=bases, lengths=lengths, read_index=idx,
            length=b.bases.shape[1]))
    return local


def _merge_rank_tables(out_dir: str, nproc: int, keep: bool) -> str:
    """Rank 0 concatenates overlaps.rank<r>.tsv into one overlaps.tsv (one
    header; rank order is global query-row order, so the table is row for
    row what one process writes), byte for byte: a name's latin-1 bytes
    pass as the writer wrote them. The rank files are removed after the
    merge unless keep (--keep-intermediates)."""
    merged = os.path.join(out_dir, "overlaps.tsv")
    tmp = merged + ".tmp"
    found = []
    with open(tmp, "wb") as out:
        out.write(HEADER.encode())
        for r in range(nproc):
            path = os.path.join(out_dir, f"overlaps.rank{r}.tsv")
            if not os.path.exists(path):
                logger.warning(
                    "rank table %s not visible (non-shared output dir?); "
                    "overlaps.tsv is missing that rank's rows", path)
                continue
            with open(path, "rb") as f:
                f.readline()  # the rank file's header
                shutil.copyfileobj(f, out, 1 << 20)
            found.append(path)
    os.replace(tmp, merged)
    logger.info("merged %d rank tables into %s", len(found), merged)
    if not keep:
        for path in found:
            try:
                os.remove(path)
            except OSError:
                pass
    return merged


def _rank_embed_fingerprint(config: PipelineConfig, local: PackedReads,
                            library: KmerLibrary, pid: int, nproc: int,
                            start: int, end: int) -> dict:
    fp = pipeline._embed_fingerprint(config, local, library)
    fp.update({"rank": pid, "nproc": nproc, "start": start, "end": end})
    return fp


def _ignored_flags(config: PipelineConfig) -> list[str]:
    """The flags set that the JAX runtime does not read on this path."""
    return [flag for bad, flag in (
        (config.knn_hbm_budget is not None, "--knn-hbm-budget"),
        (config.profile, "--profile"),
        (config.import_library is not None, "--import-library"),
        (config.import_projection is not None, "--import-projection"),
        (config.mesh_shape is not None, "--mesh-shape"),
        (config.knn_sharded != "auto", "--knn-sharded"),
    ) if bad]


def _load(config: PipelineConfig, group: ProcessGroup, row_multiple: int,
          pin_memory: bool):
    """(local PackedReads, global names, n_reads, start, end): the shared
    cache, else the byte-range parse, else the whole file parsed here."""
    packed_all = _pack_input_shared(config, group)
    if packed_all is None:
        ranged = _pack_input_ranged(config, group, row_multiple, pin_memory)
        if ranged is not None:
            return ranged
        logger.info("[rank %d] input not byte-range parseable; parsing the "
                    "full file locally", group.rank)
        packed_all = _parse_full(config)
    n_reads = packed_all.n_reads
    if n_reads == 0:
        raise ValueError(f"no reads found in {config.input_path}")
    start, end = host_read_range(n_reads, group.rank, group.size,
                                 row_multiple)
    return (_local_slice(packed_all, start, end, pin_memory),
            packed_all.names, n_reads, start, end)


def run_pipeline_multihost(config: PipelineConfig, device: torch.device,
                           mesh: Optional[Sequence[torch.device]] = None):
    """This process's part of a multi-process run on `device` (its k-NN
    entries: `mesh`, by default every visible card on a CUDA run and
    `device` alone on a CPU run). Returns a pipeline.PipelineResult of
    this rank: the global names, the global library, its own embedding
    rows and neighbor rows (global row numbers; row_offset = 2 * start),
    and the merged overlaps.tsv on rank 0 (this rank's table elsewhere).
    With one process, pipeline.run_pipeline."""
    group = initialize_distributed(config.coordinator, config.num_processes,
                                   config.process_id)
    if group.size == 1:
        return pipeline.run_pipeline(config, device, mesh)
    try:
        return _run_rank(config, device, mesh, group)
    finally:
        shutdown(group)


def _run_rank(config: PipelineConfig, device: torch.device,
              mesh: Optional[Sequence[torch.device]],
              group: ProcessGroup) -> pipeline.PipelineResult:
    set_logging_level(config.log_level)
    pid, nproc = group.rank, group.size
    for flag in _ignored_flags(config):
        logger.info("[rank %d] %s does not apply to a multi-process run; "
                    "ignored", pid, flag)
    if mesh is None:
        mesh = make_mesh().devices if device.type == "cuda" else [device]
    mesh = make_mesh(devices=mesh)
    transport = DeviceTransport(group, mesh.devices)
    out_dir = config.output_dir
    metrics = StageMetrics(device)
    sampler = (MemorySampler(os.path.join(out_dir, f"mprof.rank{pid}.dat"))
               if config.mprof and out_dir else None)
    ckpt_dir = (os.path.join(out_dir, "checkpoints")
                if config.checkpoint and out_dir else None)
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
    if sampler:
        sampler.__enter__()
    out_path = None
    try:
        with metrics.stage("load"):
            # the quota keeps each rank's 2 * per rows divisible over its
            # local k-NN entries
            local, names_global, n_reads, start, end = _load(
                config, group, mesh.size, device.type == "cuda")
        logger.info("[rank %d/%d] owns reads [%d, %d) of %d", pid, nproc,
                    start, end, n_reads)

        # staged lazily, once: a run resumed from both checkpoints skips it
        staged_once: list = []

        def get_staged():
            if not staged_once:
                with metrics.stage("stage"):
                    before = pipeline.upload_bucket.bytes
                    staged_once.append(
                        pipeline.stage_reads(local, config, device))
                    metrics.add_work(
                        "stage",
                        h2d_bytes=pipeline.upload_bucket.bytes - before)
            return staged_once[0]

        with metrics.stage("count"):
            library = None
            if ckpt_dir:
                lib_ckpt = pipeline._try_load_library_ckpt(config, ckpt_dir,
                                                           device)
                # the build is collective (allgather_library): every rank
                # takes the same branch, so resume only when all see it
                found = group.process_allgather(
                    np.asarray([lib_ckpt is not None]))
                if bool(found.all()):
                    library = lib_ckpt
            if library is None:
                shard = build_library(
                    [b.staged for b in get_staged()], 1,
                    config.kmer_sample_fraction, config.seed)
                library = allgather_library(group, shard,
                                            config.kmer_min_multiplicity)
                if ckpt_dir and pid == 0:
                    pipeline._save_library_ckpt(config, ckpt_dir, library)
            logger.info("[rank %d] global library: %d k-mers", pid,
                        library.size)
            if library.size == 0:
                raise ValueError(
                    "k-mer library is empty: no k-mer passed the "
                    "multiplicity/sampling filters (lower "
                    "--kmer-min-multiplicity or raise "
                    "--kmer-sample-fraction)")

        with metrics.stage("project"):
            # from the seed, as the JAX runtime builds it (no import)
            proj = pipeline.build_projection(
                dataclasses.replace(config, import_projection=None),
                library, None, device)

        with metrics.stage("embed"):
            emb_local = None
            emb_npy = (os.path.join(ckpt_dir, f"embeddings.rank{pid}.npy")
                       if ckpt_dir else None)
            emb_meta_path = (emb_npy.replace(".npy", ".meta.json")
                             if emb_npy else None)
            fp = _rank_embed_fingerprint(config, local, library, pid, nproc,
                                         start, end)
            if emb_npy and os.path.exists(emb_npy) \
                    and os.path.exists(emb_meta_path):
                with open(emb_meta_path) as f:
                    if json.load(f) == fp:
                        logger.info("[rank %d] resuming embeddings from %s",
                                    pid, emb_npy)
                        emb_local = torch.from_numpy(
                            np.load(emb_npy)).to(device)
            embedded = emb_local is None
            if embedded:
                d = projection_width(proj, config.embedding_dimension)
                emb_local = pipeline.compute_embeddings(
                    local.n_reads, get_staged(), library, proj, d,
                    local.split_read_ids, config.window_batch, device)
                if emb_npy:
                    np.save(emb_npy, emb_local.cpu().numpy())
                    with open(emb_meta_path, "w") as f:
                        json.dump(fp, f)
        if embedded:
            metrics.add_work("embed", hbm_bytes=pipeline.embed_hbm_bytes(
                get_staged(), library.codes, proj, local.n_reads, d))
        # embed was the last user of the staged rows and the table
        staged_once.clear()
        del proj

        per = process_quota(n_reads, nproc, mesh.size)
        with metrics.stage("knn"):
            strategy = os.environ.get(MULTIHOST_KNN_ENV,
                                      config.knn_shard_strategy)
            if config.knn_method == "ivf" and strategy != "host":
                logger.info("[rank %d] IVF k-NN over %d processes x %d "
                            "local entries (%s transport)", pid, nproc,
                            mesh.size, transport.kind)
                idx, dist = knn_ivf_sharded_multihost(
                    emb_local, n_reads, per, config.n_neighbors,
                    n_clusters=config.knn_ivf_clusters,
                    n_probes=config.knn_ivf_probes,
                    spill=config.knn_ivf_spill,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer, mesh=mesh,
                    transport=transport)
            elif strategy == "host":
                # every rank's rows gathered to every rank over the host
                # group, then this rank's rows searched over all of them
                block = np.zeros((2 * per, emb_local.shape[1]), np.float32)
                block[: emb_local.shape[0]] = emb_local.cpu().numpy()
                gathered = group.process_allgather(block)
                emb_global = torch.from_numpy(gathered.reshape(
                    -1, emb_local.shape[1])[: 2 * n_reads]).to(device)
                en = normalize_rows(emb_global)
                idx, dist = knn_exact_block(
                    en[2 * start : 2 * end], en, config.n_neighbors,
                    query_tile=config.knn_query_tile,
                    candidate_tile=config.knn_candidate_tile,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer)
                del emb_global, en
            else:
                logger.info("[rank %d] k-NN %s over %d processes x %d "
                            "local entries (%s transport)", pid, strategy,
                            nproc, mesh.size, transport.kind)
                idx, dist = knn_exact_sharded_multihost(
                    emb_local, n_reads, per, config.n_neighbors,
                    strategy=strategy, precision=config.knn_precision,
                    transfer=config.knn_transfer,
                    candidate_tile=config.knn_candidate_tile,
                    mesh=mesh, transport=transport,
                    query_tile=config.knn_query_tile)
            # this rank's share: its query rows over every candidate row
            pipeline.add_knn_work(metrics, emb_local.shape[0], 2 * n_reads,
                                  emb_local.shape[1], idx,
                                  config.knn_transfer, device)

        with metrics.stage("output"):
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                out_path = os.path.join(out_dir, f"overlaps.rank{pid}.tsv")
                write_overlaps_path(out_path, names_global, idx, dist,
                                    row_offset=2 * start)
                if config.save_feature_matrix:
                    np.savez_compressed(
                        os.path.join(out_dir,
                                     f"feature_matrix.rank{pid}.npz"),
                        embeddings=emb_local.cpu().numpy(),
                        names=np.array(local.names),
                        row_offset=2 * start)
                # every rank table exists before rank 0 merges; the second
                # barrier keeps every rank alive until the merged table
                # is on disk
                group.barrier("rank_tsv")
                if pid == 0:
                    out_path = _merge_rank_tables(
                        out_dir, nproc, keep=config.keep_intermediates)
                group.barrier("merged")
    finally:
        if sampler:
            sampler.__exit__(None, None, None)
    summary = metrics.summary()
    summary["transport"] = {"kind": transport.kind,
                            "blocks": transport.blocks,
                            "bytes": transport.bytes,
                            "cards": [str(d) for d in mesh.devices]}
    if out_dir:
        with open(os.path.join(out_dir, f"metrics.rank{pid}.json"),
                  "w") as f:
            json.dump(summary, f, indent=2)
    return pipeline.PipelineResult(
        names=names_global, library=library, embeddings=emb_local,
        neighbor_indices=idx, neighbor_distances=dist, metrics=summary,
        overlaps_path=out_path, row_offset=2 * start)
