#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fedrann_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases; any failure exits non-zero and prints no result line:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from fedrann_tpu_torch/csrc/; the static shared
     memory of kernel B's one-block kernels must fit the STATIC_SMEM that
     their plan keeps beside the survivor buffer;
     (b) build the host library (native/fastxpack.cpp, g++) into
         fedrann_tpu_torch/_kernels/, with its time; it must load from
         there, and native/libfastxpack.so must never be mapped;
  3. run each kernel against its plain PyTorch version on the card, at the
     shapes of the main-path run below (its chunk as the native packer
     packs it, unpacked for the byte source): stage_rows (kernels A and B
     fused, against the plain composition of the two, dropped counts
     included)
     and canonical_sample must match bitwise, select_candidates must refuse
     those rows (they stage fused), membership_embed to rtol 1e-5, atol
     1e-6 * max|mags| * hits (float32 sums taken in another order), also
     at d = 32, where its time is mostly the library lookups (logged
     beside d = 512's);
     (b) kernel C's dense form (membership_embed_dense) at the same chunk
         with the float32 and bfloat16 tables build_precompute_paired
         builds, and at a chunk of each golden dataset (d = 256, the
         imported float32 table, k = 15 and 21), to rtol 1e-5, atol 1e-6 *
         max|P| * hits, hit counts bitwise, the same bytes in two
         launches, with its time, device us a launch, its byte bound (each
         distinct library row read once) and the every-hit figure beside
         it, and F.embedding_bag over the same hit rows;
     (c) kernel A and the fused kernel on the packed source (the packer's
         2-bit stream with row lengths, as the pipeline uploads buckets
         without mid-read N) and on the bits source (the stream with valid
         bits, mid-read N across a block edge, in a halo and at a block
         start), against unpack_bases[_len] + the plain composition,
         bitwise, dropped counts included, each logged with its time,
         bound and device us beside the byte source's on the same bases:
         at the main chunk, at buckets of 10,000 and 10,002 bases (rows of
         2,500 and 2,501 bytes), then in phases 5a (the first 262,144
         chunk, 1,024 threads) and 5c (the keep_all 32,768 and 65,536
         chunks, kernel A and B's device-memory path);
  4. drive the main path through fedrann_tpu_torch.cli.main on ~7,500
     simulated reads (5 Mb genome, 12x, 8 kb, 5% error) with the flags of
     the bench.py workload (k=15, 5% sampling, d=512, 50 neighbors), with every
     kernel's launch count reset just before: overlaps.tsv must hold 50
     neighbor slots per embedding row less the self rows, every kernel of
     the path must have launched (each staging path exactly where its plan
     picks it: the fused kernel for rows kept in one block, kernel A and
     B's device-memory path for the others), and the truth recall of pairs
     overlapping >= 4 kb must reach 0.9; the rows stage fused there, from
     the packed source: every CLI run here loads through the native packer
     (pack_reads_native counted, the Python reader and packer never) and
     uploads 2-bit buckets from pinned memory (no byte-source launch, no
     pinning copy), and writes through the C writer; its load, output and
     upload figures are logged;
     (b) the same at --projection-dtype f32 and bf16: the dense form must
         launch and the sign form must not, and K8 must build the table
         (K5 must not); project and embed seconds logged beside phase 4's
         and beside the project seconds of the dense table built by torch
         ops (PROJECT_TORCH_OPS_S);
     (c) phase 4 again on the same -o: it must load from fxcache.npz (no
         parse), with its load seconds; then the load's pieces timed alone
         (the parse on 1 and 8 threads, the pack into pinned and pageable
         memory, the cache write and load);
     (d) --keep-intermediates, then the same again: the rerun resumes the
         library and the embeddings, launches no staging kernel and no
         kernel C, and writes a byte-identical overlaps.tsv;
     (e) run_pipeline with --profile --mprof --save-feature-matrix:
         trace/trace.json, mprof.dat and feature_matrix.npz exist, the
         .npz embeddings equal the result's, and the trace gives the
         run's device busy time and idle share;
     (f) phase 4's reads and flags at --knn-precision fp32 (K4's fp32
         form), checked as phase 4 (truth recall >= 0.9), the fp32 form
         launched once, its neighbor agreement with phase 4's table and
         knn seconds logged; then again at --knn-hbm-budget 16M, out of
         core: the card's plan's slabs and blocks uploaded, one fp32
         launch a slab and block, agreement >= OOC_AGREE_CLI with the
         in-core fp32 table;
  5. long reads (~667 simulated reads, 10 Mb genome, 10x, 150 kb, 5% error,
     in the 131,072- and 262,144-base buckets), same flags:
     (a) at the first staging chunk of the 262,144-base bucket (5%
         sampling), whose rows the plan keeps in one block: the fused
         kernel (1,024 threads) against the plain composition, bitwise,
         with kernel B's device-memory path (forced) checked and timed
         beside it; and kernel B's device-memory path against its plain
         version at a keep_all chunk of the 32,768-base bucket;
     (b) the CLI on the long reads with the launch counts reset just
         before, checked as in phase 4 (the staging paths as the plan
         picks them for the two buckets), with the truth recall of pairs
         overlapping >= 75 kb;
     (c) ~40 simulated reads of ~40 kb (200 kb genome, 8x) at
         --kmer-sample-fraction 1.0, whose keep_all rows only kernel B's
         device-memory path can stage: first kernel A and that path
         against their plain versions, bitwise, on the first chunk of each
         such bucket as packed and with INVALID bases marked, with A's
         time and bound there; then the CLI, where A and that path must
         launch, recall of pairs overlapping >= 20 kb;
     (d) the long reads plus 8 error-free reads of 400,000-1,000,000
         bases cut from the same genome, which the auto ladder splits:
         the merged union of their segments through kernel C against the
         plain union (per-segment read_hits_staged, unique,
         embed_hits_paired_signs) at phase 3's tolerance; then
         run_pipeline with phase 4's flags: kernel C launched once per
         staging chunk and once for the union, every ultra-long read's
         rows nonzero, recall of pairs involving one and overlapping
         >= 75 kb;
  6. the capability probes (fedrann_tpu_torch.probes, the counterparts of
     bench/probe_mosaic.py and bench/probe_mosaic2.py): each probe kernel
     against its plain version (integers and the P6-B store bitwise, float
     sums to rtol 1e-5, atol 1e-6 * terms * max|q|; P1 must accept exactly
     the sizes within the card's shared-memory opt-in limit and refuse the
     next), fk_probe_dyn_rows also bitwise against its hit-order replay
     (`probes._dyn_rows_replay`, computed on the host) in every mode;
     fk_probe_smem_input also every step's sum, at the probe inputs and
     on full-range random blocks, aligned and off 16 bytes;
     fk_probe_bsearch also query by query (each launched alone) against
     torch.searchsorted on edge tables (n = 1, 2, 3, 8,191, 8,192, 8,193,
     runs of equal entries, a table off 16 bytes) and past one round of
     blocks; the device time per launch (torch.profiler) of every probe
     kernel (P1, P2/P5, P4 and each dyn_rows mode) is logged beside the
     per-call times and its plain version's, with the host paths of P1,
     P2/P5 and P4 timed piece by piece, and P4's latency floor (its own
     kernel on one query: the launch, one 32 KB table copy into one SM and
     one search, whose dependent shared-memory loads are priced at the
     clock cycles a chain of them measures); then the probe entry point
     `all` with its counts reset just before: every probe kernel must
     launch;
  7. golden parity: run_pipeline on bench/golden/data (k = 15) and
     data_k21 (k = 21) with tests/test_golden_parity.py's flags (the
     reference's library and projection imported): recall@20 >= 0.99,
     distance MAE < 5e-3 and query coverage 1.0 against overlaps_ref.tsv
     (fedrann_tpu_torch.eval), min cosine > 0.999 against
     ref_embeddings.npy, the dense form and the fused staging kernel
     launched.
  8. the out-of-core k-NN, run after 4e on phase 4's reads:
     (a) the CLI at --knn-hbm-budget 16M, checked as phase 4 (recall >=
         0.9 at >= 4 kb), with the plan logged: the valve trips, the
         search uploads the plan's >= 2 query slabs x >= 4 candidate
         blocks and never calls knn_exact, kernel C launches once per
         staging chunk into its reused buffer, the embed stage's peak
         device memory stays below the (2R, d) float32 matrix, and
         neighbor agreement with phase 4's in-core overlaps.tsv >= 0.99;
     (b) knn_exact_ooc on 262,144 x 512 rows (rank 16 plus noise, from
         FLAGS' --seed), k = 50, at 256 MiB: the card's plan's slabs and
         blocks (K4's own footprint counted), peak device memory within
         the budget plus what one merge at the plan's slab x block holds
         past the plan's count (logged with that merge's time and units),
         agreement >= 0.999 and sorted distances within 1e-6
         against an in-core top-k over the same wire rows on 2,048
         sampled queries (K4 in one launch), and that top-k against
         merge_block_plain at phase 12's bars; its seconds, H2D bytes
         and rate, one block's copy alone, one merge's time (K4 and the
         plain version) and knn_exact's seconds on the same rows logged.
  9. the sharded k-NN and step (knn/ring.py, parallel/), run after 8:
     (a) knn_exact_sharded with ring, allgather and ring2d (2 x 2) over a
         mesh of the card repeated 4 times, on 65,536 x 512 rows (8b's
         structure), k = 50, against knn_exact: agreement >= 0.9999,
         distances within 1e-5; each call's cold and warm seconds beside
         knn_exact's, peak device memory and merges logged;
     (b) phase 4's reads through the CLI with --knn-sharded always, once
         per strategy, checked as phase 4: knn_exact_sharded called once
         over device_count() cards, the staging kernels and kernel C
         launched as in phase 4, agreement >= 0.999 with phase 4's
         overlaps.tsv (byte-identical or not), knn seconds beside phase
         4's;
     (c) the sharded step on phase 4's first bucket over the same 4-entry
         mesh: fk_stage_rows and fk_membership_embed_dense launch once per
         entry, agreement >= 0.999 with stage + dense embed + knn_exact on
         one device;
     (d) with two or more cards: 9a and 9c over every card, each hand
         kernel of the main path on the last card (cuda:0 current)
         against its plain version, and one block's peer-copy rate; on
         one card a line says so.
  10. the multi-process runtime, run after 9 on phase 4's reads and flags:
     two rank processes of the CLI (--num-processes 2 --process-id r
     --coordinator 127.0.0.1:<port>), each with its own launch counts
     (RANK_DRIVER writes them beside metrics.rank<r>.json): (a) the
     shared fxcache.npz (rank 0 parses, rank 1 loads) with ring, (b)
     --no-pack-cache (each rank parses its byte range) with allgather,
     (c) ring2d and FEDRANN_TPU_MULTIHOST_KNN=host, (d)
     --keep-intermediates, then a resumed rerun (no staging kernel, no
     kernel C, byte-identical overlaps.tsv); each checked as 9b: truth
     recall >= 0.9 (fedrann_tpu_torch.eval truth_recall, as every CLI run
     here), agreement >= 0.999 with phase 4's table, each rank's gathered
     library equal to 4d's single-process one, K1+K2 and K3 launched in
     both ranks, the transport (gloo on one card) in the log and in
     metrics.rank<r>.json; each run's wall seconds, each rank's stage
     seconds and the knn's TFLOP/s and mfu logged. (e) only with two or
     more cards: one card a rank, the transport must be NCCL, one hop's
     GB/s; with four or more, two cards a rank (ring2d). The card's
     compute mode is logged.
  11. the IVF k-NN (--knn-method ivf) on every path, run after 10:
     (a) phase 4's reads through the CLI (auto C = 256, p = 8, spill 2),
         checked as phase 4 at truth recall >= the lower of 0.9 and the
         JAX package's own (JAX_IVF_RECALL, tools/jax_ivf_truth_recall.py
         on a CPU): knn_ivf called once past its valve; agreement with
         phase 4 logged; a second run on a fresh -o writes a
         byte-identical overlaps.tsv; with C = p = 16, agreement >= 0.999
         with phase 4's table; at --knn-precision fp32 (K6's fp32 form),
         checked as phase 4; every run launches K4 (the k-means and the
         cluster ranking), K6 and K7 (knn_expected);
     (b) knn_ivf on 262,144 x 512 rows of read-overlap geometry made on
         the card from --seed (a 30 Mb genome in 500 bp Gaussian tiles,
         131,072 reads of 15 kb +- 20%, a row per strand: each the sum of
         its tiles plus noise), k = 50: cold and warm seconds beside
         knn_exact's, C, p, spill, size classes, padded and real
         pair-scores, recall against knn_exact on 2,048 sampled queries
         (>= IVF_SEARCH_RECALL); a third run split by step
         (ivf_step_split: CUDA events and the host clock around the
         k-means assignment, segment sums, spill/probe ranking, member and
         probe sides (K11), rescore, merge and keys_to_host; the segment
         sums, K9, logged beside SEGMENT_TORCH_OPS_MS), its neighbors
         the warm run's; a fourth under torch.cuda.set_sync_debug_mode(
         "error") from _tables' return until K6's launch
         (no_sync_until_k6), its neighbors the warm run's; self at rank
         0, sorted rows, no index twice, every distance within 1e-5 of a
         recompute;
     (c) knn_ivf_ooc: (a) at --knn-hbm-budget 16M (knn_ivf_ooc called,
         K4 launched for its k-means, probes and slab loop, K6 and K7 not;
         agreement with (a) logged), and on (b)'s rows at 256 MiB: recall
         on (b)'s queries >= (b)'s - 0.01; seconds beside 8b's
         knn_exact_ooc, blocks uploaded against exact out-of-core's,
         dropped votes and peak device memory logged;
     (d) knn_ivf_sharded over 4 entries of the card (and with two or
         more cards, over every card) on 65,536 rows of (b)'s structure:
         recall >= one-card knn_ivf's - 0.02, seconds beside it, and
         whether the two are equal; then phase 4's reads with
         --knn-sharded always --knn-method ivf (knn_ivf_sharded called,
         agreement >= 0.99 with (a)'s table); it and 8b log the bytes
         torch's host cache keeps page-locked (pinned_bytes);
     (e) two rank processes of the CLI with --knn-method ivf, checked as
         phase 10 against (a)'s table (agreement >= 0.99), each rank
         calling knn_ivf_sharded_multihost once; gloo on one card, and
         with two or more cards also one card a rank over NCCL (with
         four, two cards a rank too).
  12. the hand k-NN and sign-table kernels, run after 4e: K4's build
     (each instance's registers and spills from ptxas -v's log), then K4
     (csrc/knn_merge.cu) against merge_block_plain on the card at phase
     4's rows (4d's checkpoint, 15,000 x 512, k = 50, bf16, then the fp32
     form on float32 and on bfloat16 rows; each also at K4_SPLITS forced
     units, bitwise the planned split's keys), at K4_ROWS x 512 and at
     OOC_ROWS x 512 on OOC_SAMPLE sampled queries (rank 16 plus noise;
     both forms, each beside torch.matmul of its rows), and on edge cases (zero rows, ragged m,
     n and d, m below a block, k past n, the ids form with a carry holding
     EMPTY_KEY slots, both precisions): every kernel score within K4_TOL
     of the plain score of its pair, each row's neighbor set the plain
     one's but where the plain k-th and (k+1)-th scores are within
     K4_TOL, agreement >= K4_AGREE; the kernel's time, units, bound and
     share beside the plain version's, the bf16 product alone
     (torch.matmul) and torch.topk on the keys. K5 (csrc/srp_signs.cu) bitwise against sign_table_plain on
     the card at phase 4's library size, and after 5b at the long reads'
     (the library sizes the runs log), each with its time and bound; K8
     (the same source) bitwise (integer views) against paired_table_plain
     there in float32 and bfloat16, and on edge cases (L = 0 and 1, d = 1
     and 100, density 1.0, a negative bound, counts equal to 2L, a key
     with its top bit set), each with its time, device us and bound.
     Phase 4's knn logs its first-run set-up split (the library load, the
     first K4 launch, keys_to_host); 4e's trace must show no GEMM and no
     top-k kernel in the knn stage and no int64 elementwise chain in the
     project stage. Every CLI run must launch K4 (but the in-core and
     sharded IVF searches, which need not) and, with the sign table, K5;
     no CUDA tensor reaches either plain version in a CLI run.
     Then the IVF search's kernels (check_ivf_kernels): their build
     (ptxas -v of every instance); K6
     (csrc/ivf_rescore.cu) bitwise rescore_plain on grid rows (entries
     k / 64, every score exact) at both precisions and d = 512, the CLI's
     500 and 130 (rows of no 16-byte width, which go in as a copy padded
     to a 16-byte pitch, counted in .padded_launches), at its edge cases (a
     1-member cluster, one past a tile and the first selection's 256
     members, k past the members, sentinel rows, unprobed and empty
     clusters, C = 8, a query row offset) at W = 1, 50, 64 and 100, on a
     700-member cluster whose later tiles beat every earlier key (its
     rows overflow their survivor slots; W = 1, 50, 64, 100) and at
     phase 4's size; on phase 4's rows at C = 256, 11b's rows at C =
     1,024 and 11b's rows cut to the CLI's d = 500, spill 2, both
     precisions: index-set agreement >= K6_AGREE and
     scores within K6_TOL of the plain lists', two launches
     byte-identical, its time, device us, TFLOP/s, bound and share beside
     the plain version's and PR 16's (PR16_MS); K7 bitwise
     merge_buffers_plain on K6's buffers at spill 1, 2 and 3 and on sorted
     lists with recurring indices (rows its exact finish takes; k past its
     network's 512), timed beside the plain version, torch.topk of the
     buffer rows and PR 16's; K4 as the
     cluster ranking (_top_clusters) against top_clusters_plain at
     agreement >= K6_AGREE, ties to the lower of two equal centroids; K9
     (csrc/ivf_segment_sum.cu) bitwise segment_sum_plain on phase 4's rows
     at C = 256 and 11b's at C = 1,024 with the assignments of their own
     k-means, on float32 and bfloat16 rows (the out-of-core wire), two
     launches byte-identical, its bucketing equal to _segments' there and
     at C = 65,536, and on edge cases (empty clusters, one cluster holding
     every row, a one-row cluster, N = 1, C = 8, d = 100, zero rows, C =
     65,536), its whole call (bucketing included) timed with each
     kernel's device us beside the plain version, index_add_ and the
     earlier design's (EARLIER_MS). K10 (csrc/result_wire.cu, the result
     wire: keys_to_host on CUDA keys) byte-identical keys_to_host_plain
     on the k-NN keys of phase 4's rows (15,000 x 50, uint16 indices on
     the u16 wire) and 11b's (262,144 x 50, int32 indices), on both
     wires, with EMPTY_KEY slots, at rows = 0 and k = 1, on the wire's
     edge scores, two results held at once, and a result in a
     page-locked block of its own (past topk.PIN_CACHE_BYTES, freed with
     it); each timed beside the plain
     version and a pinned copy_ of its result bytes (a floor), its bound
     the result over the host link's nominal rate. K11
     (csrc/ivf_segment_sum.cu fk_ivf_bucket, the member and probe
     buckets and K6's work list, one cooperative launch a side) bitwise
     bucket_clusters_plain (its work list as a set of rows, longest
     member counts first), expanded bitwise member_table_plain and
     probe_tables_plain, two calls equal, at phase 4's C = 256 and 11b's
     C = 1,024 (spill 1 and 2, p = 8) and at its edge cases
     (k11_edge_cases, C = 2,048 to 65,536 included), each whole step
     timed with its device us beside a stable torch.sort of the same ids;
     K6 on K11's work list bitwise K6 on the host's (ivf.host_units).
     Every IVF CLI run but out of core launches K6, K7 and K11 (one
     member side, and one probe side for each K6 launch), and every
     one K9 (three launches a k-means); every CLI run launches K10; no
     CUDA tensor reaches rescore_plain, merge_buffers_plain,
     top_clusters_plain, segment_sum_plain, keys_to_host_plain,
     member_table_plain, probe_tables_plain, bucket_clusters_plain or
     bucket_units_plain.
8a runs twice: the second time under --profile, so the out-of-core
search's merge launches run inside a torch.profiler session.
With --profile, phases 4 and 5b are each followed by two more CLI runs on
the same reads, the second under torch.profiler (`profile_cli`).
The second-to-last line is a JSON object of per-kernel launches (each from
the runs of its own path: knn_merge and srp_signs from the main path's,
srp_paired (K8) from 4b's two runs, ivf_segment_sum (K9) and ivf_buckets
(K11) from phase 11's CLI runs and ranks, result_wire (K10) from the
main path's,
knn_merge_fp32 (K4's fp32 form) from 4f's two runs, ivf_rescore,
ivf_rescore_fp32 and ivf_merge (K6's two forms and K7) from phase 11's
CLI runs and ranks, stage_rows from the
main path's, 9b's, 9c's, 10's and 11's, membership_embed from the main path's, 8a's (twice), 9b's,
10's and 11's, the other staging
kernels summed over the three CLI runs (and 9b's),
membership_embed_dense over the runs of 4b, 7 and 9c, the probes from their
entry point), errors, times, the bound (the larger of
the bytes the function must move over 3.35 TB/s, its float32 operations
over 67 TFLOP/s and its int32 operations over 16.7 T/s, counted from
this run's inputs; for the window-code kernels, integer-pipe
instructions) and the time of one PyTorch call computing the same function
where there is one; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GENOME, COVERAGE, READ_LEN, ERROR_RATE, SIM_SEED = 5_000_000, 12, 8000, 0.05, 1234
FLAGS = ["-k", "15", "--kmer-sample-fraction", "0.05",
         "--kmer-min-multiplicity", "2", "-n", "512",
         "--nndescent-n-neighbors", "50", "--seed", "602"]
MIN_OVERLAP, MIN_RECALL = 4000, 0.9
LONG_GENOME, LONG_COVERAGE, LONG_READ_LEN, LONG_MIN_OVERLAP = (
    10_000_000, 10, 150_000, 75_000)
KEEP_ALL_BUCKET = 32768
KEEP_ALL_GENOME, KEEP_ALL_READ_LEN = 200_000, 40_000
STAGES = ("load", "stage", "count", "project", "embed", "knn", "output")
# the staging kernels, the window-code ones on each source; a CLI run
# launches each where the plan picks its path and the bucket its source
# (never the byte source)
STAGE_KERNELS = ("stage_rows", "stage_rows_packed", "stage_rows_bits",
                 "canonical_sample", "canonical_sample_packed",
                 "canonical_sample_bits", "select_candidates_long")
# kernel C's two forms; a run launches the one of its projection
EMBED_KERNELS = ("membership_embed", "membership_embed_dense")
# 5d: reads cut from the long-read genome past the largest bucket (bases)
ULTRA_READS, ULTRA_MIN, ULTRA_MAX = 8, 400_000, 1_000_000
GOLDEN = ("data", "data_k21")
GOLDEN_RECALL, GOLDEN_MAE, GOLDEN_COSINE = 0.99, 5e-3, 0.999
# 8a: the main path past this --knn-hbm-budget (>= 2 slabs, >= 4 blocks);
# 8b: a search of OOC_ROWS x 512 (131,072 reads) at OOC_BUDGET bytes, held
# against an in-core top-k on OOC_SAMPLE query rows
OOC_CLI_BUDGET = "16M"
OOC_ROWS, OOC_BUDGET, OOC_SAMPLE = 262_144, 256 << 20, 2048
OOC_AGREE_CLI, OOC_AGREE_SEARCH = 0.99, 0.999
# 9a: the sharded search on SHARD_ROWS x 512 rows (8b's structure), k =
# SHARD_K, over SHARD_ENTRIES entries of one card; the bars of 9a-9c
SHARD_ROWS, SHARD_K, SHARD_ENTRIES = 65_536, 50, 4
SHARD_STRATEGIES = ("ring", "allgather", "ring2d")
SHARD_AGREE_SEARCH, SHARD_AGREE_CLI, SHARD_AGREE_STEP = 0.9999, 0.999, 0.999
# 10: two rank processes, each given RANK_TIMEOUT seconds; agreement with
# phase 4's table; 10e's hop: one HOP_ROWS x 512 float32 block, best of
# HOP_REPS
MULTI_AGREE, RANK_TIMEOUT = 0.999, 300
HOP_ROWS, HOP_REPS = 16_384, 5
# 11: the IVF k-NN. The JAX package's own truth recall with --knn-method
# ivf on phase 4's reads and flags (tools/jax_ivf_truth_recall.py, on a
# CPU); 11a's runs must reach the lower of it and MIN_RECALL
JAX_IVF_RECALL = 0.9881122312427514
IVF_RECALL = min(MIN_RECALL, JAX_IVF_RECALL)
# 11b-d: read-overlap rows on the card: a genome of IVF_GENOME bases cut
# into IVF_TILE-base tiles (d = 512 Gaussian vectors a strand), reads of
# IVF_READ_LEN +- 20%, each row the sum of its strand's tiles plus noise;
# IVF_ROWS rows (IVF_ROWS / 2 reads), k = IVF_K, recall on IVF_SAMPLE
# sampled queries; 11c at OOC_BUDGET; 11d over SHARD_ENTRIES entries on
# IVF_SHARD_ROWS rows
IVF_GENOME, IVF_TILE, IVF_READ_LEN = 30_000_000, 500, 15_000
IVF_ROWS, IVF_SHARD_ROWS, IVF_K, IVF_SAMPLE = 262_144, 65_536, 50, 2048
# neighbor agreement of 11a's all-probed run with phase 4's exact table;
# of the other IVF runs (11c-e) with 11a's
IVF_AGREE_ALL, IVF_AGREE = 0.999, 0.99
# 11b's recall against knn_exact on its sampled queries (0.99879 with the
# torch stages, less 0.002 for a near-tie k-means assignment that K4's
# bf16 sums may move)
IVF_SEARCH_RECALL = 0.99879 - 0.002
# 12: K6 against rescore_plain on real rows: each (query, slot) list's
# index set agreeing >= K6_AGREE over the lists, every shared pair's score
# within K6_TOL (float32 sums of exact products in another order); K4's
# cluster ranking against top_clusters_plain: agreement >= K6_AGREE
K6_AGREE, K6_TOL = 0.999, 2e-6
# the CLI's default -n (FEDRANN's): 1,000 bytes a bf16 row, which K6 takes
# as a copy padded to a 16-byte pitch (504)
CLI_D = 500
# 4b's project seconds when torch ops built the dense table, before K8, and
# 11b's segment sums (three passes) in event ms when torch ops summed them,
# before K9 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5), logged
# beside this run's
PROJECT_TORCH_OPS_S = {"f32": 0.040, "bf16": 0.039}
SEGMENT_TORCH_OPS_MS = (11.703, 18.974)
# 12: K6's and K7's times at PR 16's design (a running top-k in device
# memory; a p-way pop merge), ms on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md), logged beside this run's: (kernel, rows) -> ms
PR16_MS = {("ivf_rescore", "phase 4"): 1.1584,
           ("ivf_rescore", "11b"): 45.8639,
           ("ivf_rescore_fp32", "phase 4"): 1.9338,
           ("ivf_rescore_fp32", "11b"): 98.2204,
           ("ivf_merge", "phase 4"): 0.1943, ("ivf_merge", "11b"): 3.8725}
# 12: K8's and K9's times at their earlier design (K8 a thread a vector
# with two 64-bit divisions; K9 after _segments' torch sort), ms on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md), logged beside this run's:
# (kernel, library size or rows, dtype) -> ms
EARLIER_MS = {("srp_paired", 309_830, "float32"): 0.7596,
           ("srp_paired", 309_830, "bfloat16"): 0.6167,
           ("srp_paired", 608_037, "float32"): 1.4956,
           ("srp_paired", 608_037, "bfloat16"): 1.2073,
           ("ivf_segment_sum", "phase 4", "float32"): 0.1815,
           ("ivf_segment_sum", "phase 4", "bfloat16"): 0.1168,
           ("ivf_segment_sum", "11b", "float32"): 0.3104,
           ("ivf_segment_sum", "11b", "bfloat16"): 0.3010}
# 12: K4 against merge_block_plain: every kernel score within K4_TOL of
# the plain score of its pair (float32 sums of 512 exact products in
# another order); neighbor sets equal but at plain near-ties; agreement
# >= K4_AGREE over every case; K4_ROWS x 512 rank-16 rows, k = K4_K
K4_TOL, K4_AGREE, K4_ROWS, K4_K = 1e-5, 0.999, 65_536, 50
# forced splits of K4's candidates held bitwise against the planned one
K4_SPLITS = (1, 2, 7)


COUNTERS: dict = {}
# host-side counts read around each CLI run: name -> (function, attribute)
HOST_COUNTERS: dict = {}
HAND_KERNELS: set = set()  # __global__ names of csrc/*.cu (is_hand)
# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): device memory bytes/s, float32 operations/s outside tensor cores,
# dense bf16 tensor-core operations/s
PEAK_BYTES, PEAK_FP32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# int32 operations/s, one integer-pipe instruction a lane a clock: 132 SMs
# x 64 INT32 lanes (16 in each of an SM's four partitions) x 1.98 GHz boost
# clock = 16.73e12
PEAK_INT32 = 16.7e12
# the host link's nominal rate each way, bytes/s: PCIe Gen5 x16, the H100
# SXM's host interface (32 GT/s a lane, 128b/130b encoding): 63.0e9
PEAK_HOST_LINK = 32e9 * 16 * 128 / 130 / 8
CSRC = "fedrann_tpu_torch/csrc/"
# kernel -> (source, the JAX function it replaces: a pl.pallas_call site,
# or for K4-K11 the XLA function, which has none)
_K12 = ("bench/pallas_kernels.py:128 canonical_and_sample, "
        "bench/pallas_sort.py:128 sort_rows_pallas")
_K1 = "bench/pallas_kernels.py:128 canonical_and_sample"
_K3 = "bench/pallas_embed.py:277 merge_embed"
SOURCES = {
    "stage_rows": (CSRC + "select_stage_rows.cu", _K12),
    "stage_rows_packed": (CSRC + "select_stage_rows.cu", _K12),
    "stage_rows_bits": (CSRC + "select_stage_rows.cu", _K12),
    "canonical_sample": (CSRC + "canonical_sample.cu", _K1),
    "canonical_sample_packed": (CSRC + "canonical_sample.cu", _K1),
    "canonical_sample_bits": (CSRC + "canonical_sample.cu", _K1),
    "select_candidates_long": (CSRC + "select_stage_rows.cu",
                               "bench/pallas_sort.py:128 sort_rows_pallas"),
    "membership_embed": (CSRC + "membership_embed.cu", _K3),
    "membership_embed_dense": (CSRC + "membership_embed.cu", _K3),
    "knn_merge": (CSRC + "knn_merge.cu",
                  "fedrann_tpu/knn/topk.py:146 _knn_tiles_qc (XLA "
                  "dot_general + lax.top_k in a lax.scan)"),
    "knn_merge_fp32": (CSRC + "knn_merge.cu",
                       "fedrann_tpu/knn/topk.py:146 _knn_tiles_qc at "
                       "precision fp32 (XLA float32 dot_general + "
                       "lax.top_k in a lax.scan)"),
    "ivf_rescore": (CSRC + "ivf_rescore.cu",
                    "fedrann_tpu/knn/ivf.py:198 _rescore_group + :219 "
                    "_scatter_group (XLA bf16 dot_general + top_k in a "
                    "lax.map, a scatter)"),
    "ivf_rescore_fp32": (CSRC + "ivf_rescore.cu",
                         "fedrann_tpu/knn/ivf.py:198 _rescore_group + :219 "
                         "_scatter_group at precision fp32"),
    "ivf_merge": (CSRC + "ivf_rescore.cu",
                  "fedrann_tpu/knn/ivf.py:227 _merge_buffers, :136 "
                  "_dedup_topk (XLA sort + top_k in a lax.map)"),
    "srp_signs": (CSRC + "srp_signs.cu",
                  "fedrann_tpu/project/srp.py:151 build_precompute_signs, "
                  ":202 _srp_sign_chunk, :219 _pack_signs (XLA)"),
    "srp_paired": (CSRC + "srp_signs.cu",
                   "fedrann_tpu/project/srp.py:90 build_precompute_paired, "
                   ":39 _srp_chunk (XLA)"),
    "ivf_segment_sum": (CSRC + "ivf_segment_sum.cu",
                        "fedrann_tpu/knn/ivf.py:83 jax.ops.segment_sum in "
                        "_kmeans :61 (XLA scatter-add)"),
    "result_wire": (CSRC + "result_wire.cu",
                    "fedrann_tpu/knn/topk.py:36 quantize_dist, :58 _idx_u16 "
                    "(XLA), in :49 transfer_dist and :95 transfer_idx"),
    "ivf_buckets": (CSRC + "ivf_segment_sum.cu",
                    "fedrann_tpu/knn/ivf.py:117 _member_table, :170 "
                    "_probe_tables (XLA stable argsort + scatter)"),
    "fk_probe_smem_scratch": (CSRC + "probes.cu",
                              "bench/probe_mosaic.py:32 probe_smem_scratch"),
    "fk_probe_smem_input": (CSRC + "probes.cu",
                            "bench/probe_mosaic.py:55 probe_smem_input, "
                            "bench/probe_mosaic2.py:30 probe_smem_input"),
    "fk_probe_dyn_rows": (CSRC + "probes.cu",
                          "bench/probe_mosaic.py:92 probe_dyn_sublane, "
                          "bench/probe_mosaic2.py:47 _try"),
    "fk_probe_bsearch": (CSRC + "probes.cu",
                         "bench/probe_mosaic.py:146 probe_scalar_bsearch"),
}
# library sizes the CLI runs log ("library: L canonical k-mers"), in order
LIBRARY_SIZES: list = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def log_kernel(name: str, r: dict, card: str) -> None:
    library = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
    log(f"kernel {name}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of it), library {library}, "
        f"max abs error {r['max_abs_err']} [{card}]")


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call of fn on the current stream (one warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def behind_busy_card(fn, reps: int) -> tuple:
    """(host us of fn's call, device us of its work by CUDA events), the
    medians of reps calls, each queued behind a ~1 ms torch.cuda._sleep
    so that the card is busy while the host enqueues: the host figure is
    the call's own (it includes any wait the launch makes for the card),
    the device figure its kernels' and the gaps between them, without the
    host's enqueue."""
    import statistics

    import torch

    host, device = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e6)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) * 1e3)
    return statistics.median(host), statistics.median(device)


def time_cuda_median(fn, reps: int, rounds: int) -> tuple:
    """(median, (least, most)) of `rounds` time_cuda(fn, reps) timings,
    ms per call: for calls bound by the host path, whose timings the
    host's jitter moves."""
    import statistics

    runs = [time_cuda(fn, reps) for _ in range(rounds)]
    return statistics.median(runs), (min(runs), max(runs))


def is_hand(name: str) -> bool:
    """Whether a profiler kernel name is one of the hand kernels: a
    __global__ function of csrc/*.cu, each in an anonymous namespace at the
    top level (a template's name starts with its return type)."""
    import re

    if not HAND_KERNELS:
        for src in sorted(os.listdir(os.path.join(HERE, CSRC))):
            if src.endswith(".cu"):
                with open(os.path.join(HERE, CSRC, src)) as f:
                    HAND_KERNELS.update(re.findall(
                        r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?"
                        r"(\w+)\(", f.read()))
    m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", name)
    return m is not None and m.group(1) in HAND_KERNELS


def bound(n_bytes: float, fp32_ops: float = 0.0,
          int32_ops: float = 0.0, bf16_ops: float = 0.0) -> dict:
    """The least time the card could take for a function that must move
    n_bytes (each input read once, each output written once) and do
    fp32_ops float32, int32_ops int32 and bf16_ops bf16 tensor-core
    operations, and which bounds it."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = max(fp32_ops / PEAK_FP32, int32_ops / PEAK_INT32,
                 bf16_ops / PEAK_BF16) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def window_op_counts(k: int, kind: str,
                     source: str = "bytes") -> tuple[int, int]:
    """(work of every window of a block the window-code function computes
    from `source`, more for each valid window it hashes), as
    csrc/window_codes.cuh counts it for this k: kind "INSTR", integer-pipe
    instructions (the floor the bound uses), or "OPS", operations at the
    source (an upper figure). A window's work is WINDOW_* plus its
    source's staging, STAGE_*."""
    import math
    import re

    with open(os.path.join(HERE, CSRC, "window_codes.cuh")) as f:
        src = f.read()
    width = "WIDE" if k > 16 else "NARROW"
    counts = []
    for names in ((f"WINDOW_{kind}_{width}", f"STAGE_{kind}_{source.upper()}"),
                  (f"HASH_{kind}_{width}",)):
        total = 0
        for name in names:
            m = re.search(rf"constexpr int {name} = ([0-9+* ]+);", src)
            if m is None:
                fail(f"no count {name} in {CSRC}window_codes.cuh")
            total += sum(math.prod(int(f) for f in term.split("*"))
                         for term in m.group(1).split("+"))
        counts.append(total)
    return counts[0], counts[1]


def window_ops(bases, k: int, keep_all: bool,
               source: str = "bytes") -> tuple[int, int]:
    """(integer-pipe instructions, source-level operations) the window-code
    function needs on these (R, L) bases (a PackedChunk's unpacked) from
    `source`: every window (below W) of each 1024-window block with a
    valid base among the 1,056 it stages (the others are skipped), and the
    hash of each valid window unless keep_all."""
    import torch

    r, length = bases.shape
    w = length - k + 1
    n_blocks = -(-w // 1024)
    bad = torch.ones((r, n_blocks * 1024 + 1057), dtype=torch.int32,
                     device=bases.device)  # past the row: INVALID
    bad[:, 0] = 0
    bad[:, 1 : length + 1] = (bases >= 4).to(torch.int32)
    cum = torch.cumsum(bad, dim=1)  # cum[:, i]: INVALID bases before i
    valid = int(((cum[:, k : w + k] - cum[:, :w]) == 0).sum())
    starts = torch.arange(n_blocks, device=bases.device) * 1024
    live = (cum[:, starts + 1056] - cum[:, starts]) < 1056
    in_row = torch.clamp(w - starts, max=1024)
    windows = int((live.to(torch.int64) * in_row).sum())
    counts = []
    for kind in ("INSTR", "OPS"):
        per_window, per_hash = window_op_counts(k, kind, source)
        counts.append(windows * per_window
                      + (0 if keep_all else valid * per_hash))
    return counts[0], counts[1]


def window_bound(n_bytes: int, ops: tuple[int, int]) -> tuple[dict, str]:
    """The bound of a window-code kernel from its bytes and window_ops'
    counts (the instructions), and a note of both counts with the upper
    figure the source-level operations give."""
    b = bound(n_bytes, int32_ops=ops[0])
    upper = bound(n_bytes, int32_ops=ops[1])["bound_ms"]
    return b, (f"{n_bytes} bytes, {ops[0]} integer-pipe instructions; "
               f"{ops[1]} source-level operations give {upper:.5f} ms")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def embed_work(staged, lib_codes, signs, d: int) -> tuple[int, int]:
    """(distinct library rows the staged rows hit, float32 adds those hits
    need): each hit adds the nonzero fields of its paired sign row."""
    import torch

    from fedrann_tpu_torch.kmers.membership import read_hits_staged
    from fedrann_tpu_torch.project.embed import _unpack_sign_rows

    lib_size = lib_codes.shape[0]
    hits, _ = read_hits_staged(staged, lib_codes)
    hits = hits[hits < 2 * lib_size]
    rows = torch.where(hits >= lib_size, hits - lib_size, hits)
    nonzero = torch.cat([(_unpack_sign_rows(signs[s : s + 8192], 2 * d) != 0)
                         .sum(dim=1) for s in range(0, lib_size, 8192)])
    return int(torch.unique(rows).numel()), int(nonzero[rows].sum())


def device_us(fn, reps: int, hand: bool, tries: int = 3) -> str:
    """Device microseconds per call of fn from torch.profiler, as text: the
    time of its hand kernels (csrc/*.cu, anonymous namespace), each named
    with its share when a call launches more than one, when `hand`, else
    of every kernel and copy it ran.

    The profiler can drop activity records (seen on the H100: 10 of 20
    launches kept in a session), so a session is taken as whole only when
    it holds a whole multiple of `reps` launches of each hand kernel
    (`hand`) or of `reps` records (the plain version); an incomplete one is
    taken again, up to `tries` sessions. If none was whole, the last is
    reported with the count it kept: the mean per kept launch for a hand
    kernel, and for the plain version the kept time over `reps`, which is
    then a lower bound. The launches themselves are checked by the
    wrappers' counts and by the comparisons, not here."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        runs = [(e.name, e.time_range.end - e.time_range.start)
                for e in prof.events() if e.device_type == DeviceType.CUDA
                and (not hand or is_hand(e.name))]
        per_name: dict[str, list] = {}
        for name, us in runs:
            per_name.setdefault((name.split("::")[1] if hand else name)
                                .split("(")[0], []).append(us)
        whole = (all(len(v) % reps == 0 for v in per_name.values()) if hand
                 else len(runs) % reps == 0)
        if runs and whole:
            total = f"{sum(us for _, us in runs) / reps:.3f}"
            if hand and len(per_name) > 1:
                total += " (" + " + ".join(
                    f"{n} {sum(v) / reps:.3f}"
                    for n, v in per_name.items()) + ")"
            return total
    if not runs:
        return f"not measured (the profiler kept no record in {tries} tries)"
    per = (sum(sum(v) / len(v) for v in per_name.values()) if hand
           else sum(us for _, us in runs) / reps)
    return (f"{per:.3f}{'' if hand else ' or more'} (the profiler kept "
            f"{len(runs)} records of {reps} calls)")


def host_us(fn, reps: int = 200, rounds: int = 9) -> float:
    """Host microseconds per call of fn: the best of `rounds` runs of
    `reps` calls back to back (one warm-up), since the host is shared."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best * 1e6 / reps


def p1_host_split(dev, n: int) -> dict:
    """Host microseconds of each piece of P1's per-call path at n entries:
    the output allocation, the stream handle, the device guard alone (a
    read of the current device), the C entry point alone (opt-in and
    launch), `_build.launch` given the stream (no device guard) and given
    the device (the guard, as the wrappers call it), the whole wrapper,
    and the plain version (torch.full) for comparison."""
    import torch

    from fedrann_tpu_torch import _build, probes

    out = torch.empty(1, 1, dtype=torch.int32, device=dev)
    ptr, s = out.data_ptr(), _build.stream(dev)
    entry = _build.kernels().fk_probe_smem_scratch
    return {
        "empty": host_us(lambda: torch.empty(1, 1, dtype=torch.int32,
                                             device=dev)),
        "stream": host_us(lambda: _build.stream(dev)),
        "c_call": host_us(lambda: entry(n, ptr, s)),
        "guard": host_us(torch._C._cuda_getDevice),
        "launch unguarded": host_us(lambda: _build.launch(
            "fk_probe_smem_scratch", n, ptr, s)),
        "launch": host_us(lambda: _build.launch(
            "fk_probe_smem_scratch", n, ptr, device=dev)),
        "wrapper": host_us(lambda: probes.smem_scratch(n, dev)),
        "plain": host_us(lambda: probes._smem_scratch_plain(n, dev)),
    }


def check_stage_rows(name: str, bases, k: int, hit_buffer: int,
                     keep_all: bool, seed: int, thr: int, block_cap,
                     card: str) -> dict:
    """Kernels A and B fused on byte rows the plan keeps in one block,
    checked and timed by check_window_kernel; its report and a log line
    with its device us per launch."""
    from fedrann_tpu_torch.device import shared_memory_limit
    from fedrann_tpu_torch.kmers.membership import stage_launch_plan

    plan = stage_launch_plan(bases.shape[1] - k + 1, hit_buffer, keep_all,
                             block_cap, shared_memory_limit(bases.device))
    if plan.long:
        fail(f"{name}: the plan keeps no row in one block")
    r, dev_us, note = check_window_kernel("stage_rows", bases, k, hit_buffer,
                                          keep_all, seed, thr, block_cap,
                                          plan)
    log(f"{name}: rows {tuple(bases.shape)} k={k} keep_all={keep_all}; "
        f"bitwise equal; {r['ms']:.4f} ms, device {dev_us} us per launch; "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {note}) [{card}]")
    return r


def mark_invalid(bases, k: int):
    """A copy of (R, L) bases with INVALID bases across a block edge (rows
    0 mod 3), in a block's halo (1 mod 3) and at a block's start (2 mod
    3): mid-read N."""
    marked = bases.clone()
    marked[0::3, 1020:1030] = 4
    marked[1::3, 2048 + k // 2] = 4
    marked[2::3, 3072] = 4
    return marked


def packed_chunk(bases, lengths=None):
    """The 2-bit form of (R, L) byte rows on their device, as the native
    packer fills it (io/packing.py bit_pack): the packed source (the row
    lengths; the rows' valid bases must be a prefix) when `lengths` is
    given, else the bits source (the valid bits). Its unpacked bytes must
    be `bases`."""
    import torch

    from fedrann_tpu_torch.io.packing import bit_pack
    from fedrann_tpu_torch.kmers.codec import PackedChunk

    packed, valid = (torch.from_numpy(a).to(bases.device)
                     for a in bit_pack(bases.cpu().numpy()))
    chunk = (PackedChunk(packed, bases.shape[1], lengths=lengths)
             if lengths is not None else
             PackedChunk(packed, bases.shape[1], valid_bits=valid))
    if not torch.equal(chunk.unpack(), bases):
        fail(f"the {chunk.source} form does not unpack to its bases")
    return chunk


def check_window_kernel(kernel: str, x, k: int, hit_buffer: int,
                        keep_all: bool, seed: int, thr: int, block_cap,
                        plan) -> tuple[dict, str, str]:
    """Kernel A ("canonical_sample") or the staging stage ("stage_rows":
    the fused kernel on a one-block plan, kernel A then B's device-memory
    path on a long one) on x, a byte matrix or a PackedChunk, against the
    plain version on x's bytes (unpack_bases[_len] first), bitwise, dropped
    counts included, each launch counted on x's source. Returns (report,
    device us per launch, bound note); the report of a long plan's stage
    is None (kernel A's carries its time)."""
    import torch

    from fedrann_tpu_torch.kmers.codec import (
        _canonical_sample_plain,
        as_bytes,
        canonical_sample,
        source_args,
    )
    from fedrann_tpu_torch.kmers.membership import (
        _select_candidates_plain,
        select_candidates,
        stage_candidates,
    )

    source = source_args(x)[2]
    inputs = ([x] if source == "bytes" else [x.packed, x.aux])

    def plain_a():
        return _canonical_sample_plain(as_bytes(x), k, seed, thr, keep_all)

    def kernel_a():
        return canonical_sample(x, k, seed, thr, keep_all)

    def plain_stage():
        return _select_candidates_plain(plain_a(), hit_buffer, keep_all,
                                        block_cap)

    def stage():
        return stage_candidates(x, k, hit_buffer, keep_all, seed, thr,
                                block_cap)

    fn, plain = (kernel_a, plain_a) if kernel == "canonical_sample" else (
        stage, plain_stage)
    counts = (stage_candidates, canonical_sample, select_candidates)
    before = [getattr(f, a) for f in counts[:2] for a in (
        f"{source}_launches", "launches")] + [counts[2].long_launches]
    got = fn()
    torch.cuda.synchronize()
    after = [getattr(f, a) for f in counts[:2] for a in (
        f"{source}_launches", "launches")] + [counts[2].long_launches]
    step = ((0, 0, 1, 1, 0) if kernel == "canonical_sample"
            else (0, 0, 1, 1, 1) if plan.long else (1, 1, 0, 0, 0))
    if [a - b for a, b in zip(after, before)] != list(step):
        fail(f"{kernel} on the {source} source launched {after} from "
             f"{before}, want one step of {step}")
    want = plain()
    if kernel == "canonical_sample":
        equal = torch.equal(got, want)
        outputs = [got]
    else:
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        outputs = list(got)
    if not equal:
        fail(f"{kernel} on the {source} source differs from its plain "
             f"version (unpack + plain)")
    if kernel == "stage_rows" and plan.long:
        return None, "", ""
    b, note = window_bound(nbytes(*inputs, *outputs),
                           window_ops(as_bytes(x), k, keep_all, source))
    return (dict(max_abs_err=0.0, ms=time_cuda(fn, 10),
                 plain_ms=time_cuda(plain, 3), library_ms=None, **b),
            device_us(fn, 10, True), note)


def check_sources(label: str, bases, lengths, k: int, hit_buffer: int,
                  keep_all: bool, seed: int, thr: int, block_cap,
                  card: str) -> dict:
    """Phase 3c at one shape: kernel A and the staging stage (the fused
    kernel, or A then B's device-memory path where the plan keeps no row
    in one block) on the packed source (`bases`' 2-bit form with their
    `lengths`; the rows must be prefix-valid) and on the bits source (a
    copy with mid-read N, mark_invalid, and its valid bits), each against
    unpack + plain bitwise, logged with its time, bound and device us
    beside the byte source's on the same bases. Returns the reports keyed
    "<kernel>_<source>"."""
    from fedrann_tpu_torch.device import shared_memory_limit
    from fedrann_tpu_torch.kmers.membership import stage_launch_plan

    plan = stage_launch_plan(bases.shape[1] - k + 1, hit_buffer, keep_all,
                             block_cap, shared_memory_limit(bases.device))
    marked = mark_invalid(bases, k)
    inputs = {"packed": (bases, packed_chunk(bases, lengths)),
              "bits": (marked, packed_chunk(marked))}
    reports = {}
    for kernel in ("stage_rows", "canonical_sample"):
        for source, (raw, chunk) in inputs.items():
            byte, byte_us, _ = check_window_kernel(
                kernel, raw, k, hit_buffer, keep_all, seed, thr, block_cap,
                plan)
            rep, dev_us, note = check_window_kernel(
                kernel, chunk, k, hit_buffer, keep_all, seed, thr,
                block_cap, plan)
            if rep is None:
                log(f"3c {label} {source}: kernel A and B's device-memory "
                    "path bitwise equal to unpack + plain")
                continue
            reports[f"{kernel}_{source}"] = rep
            log(f"3c {label} {kernel} {source}: rows {tuple(bases.shape)} "
                f"k={k} keep_all={keep_all}; bitwise equal to unpack + "
                f"plain; {rep['ms']:.4f} ms (plain {rep['plain_ms']:.4f}), "
                f"device {dev_us} us; bound {rep['bound_ms']:.5f} ms "
                f"({rep['bound_by']}, {100 * rep['bound_ms'] / rep['ms']:.1f}"
                f"%: {note}); the byte source {byte['ms']:.4f} ms, device "
                f"{byte_us} us, bound {byte['bound_ms']:.5f} ms "
                f"({100 * byte['bound_ms'] / byte['ms']:.1f}%) [{card}]")
    return reports


def check_kernels(fasta: str, out_dir: str, dev, card: str) -> dict:
    """Phase 3: each kernel vs its plain version at the main-path shapes
    (the first staging chunk of the largest length bucket)."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.io.native import pack_reads_native
    from fedrann_tpu_torch.kmers.codec import (
        canonical_sample,
        sample_threshold,
    )
    from fedrann_tpu_torch.kmers.library import build_library
    from fedrann_tpu_torch.kmers.membership import (
        select_candidates,
        stage_candidates,
    )
    from fedrann_tpu_torch.project.embed import (
        _membership_embed_plain,
        membership_embed,
    )
    from fedrann_tpu_torch.project.srp import build_precompute_signs

    config = config_from_args(["-i", fasta, "-o", out_dir, *FLAGS])
    packed = pipeline.load_reads(config, dev)
    bucket = max(packed.buckets, key=lambda b: b.length)
    rows = pipeline.chunk_rows(bucket.length, bucket.read_index.shape[0],
                               config)
    chunk = pipeline.upload_bucket(bucket, dev)[:rows]
    if chunk.source != "packed":
        fail(f"the main chunk uploads as {chunk.source}, want packed")
    bases = chunk.unpack()  # the byte source's input: the same bases
    hit_buffer, keep_all, block_cap = pipeline.staging_params(bucket.length,
                                                              config)
    k, seed = config.kmer_size, config.seed
    thr = sample_threshold(config.kmer_sample_fraction)
    log(f"kernel shapes: bases {tuple(bases.shape)} k={k} "
        f"hit_buffer={hit_buffer} block_cap={block_cap}")
    report = {}
    report["stage_rows"] = check_stage_rows(
        "stage_rows", bases, k, hit_buffer, keep_all, seed, thr, block_cap,
        card)
    # 3c: the packed and bits sources at the main chunk, then at buckets of
    # 10,000 and 10,002 bases (rows of 2,500 and 2,501 bytes)
    report.update(check_sources("main chunk", bases, chunk.lengths, k,
                                hit_buffer, keep_all, seed, thr, block_cap,
                                card))
    for length in (10000, 10002):
        cfg = config_from_args(["-i", fasta, "-o", out_dir, *FLAGS,
                                "--length-buckets", str(length)])
        odd = pack_reads_native(fasta, (length,)).buckets[0]
        n = pipeline.chunk_rows(length, odd.read_index.shape[0], cfg)
        odd_chunk = pipeline.upload_bucket(odd, dev)[:n]
        if odd_chunk.source != "packed":
            fail(f"the {length}-base bucket uploads as {odd_chunk.source}")
        hb, every, cap = pipeline.staging_params(length, cfg)
        check_sources(f"{length}-base bucket", odd_chunk.unpack(),
                      odd_chunk.lengths, k, hb, every, seed, thr, cap, card)

    report["canonical_sample"], dev_us, note = check_window_kernel(
        "canonical_sample", bases, k, hit_buffer, keep_all, seed, thr,
        block_cap, None)
    log(f"canonical_sample: device us per launch {dev_us}; bound "
        f"({report['canonical_sample']['bound_by']}: {note}) [{card}]")
    slots = canonical_sample(bases, k, seed, thr, keep_all)

    # kernel B reads slots only on its device-memory path: rows the plan
    # keeps in one block stage from their bases, fused
    try:
        select_candidates(slots, hit_buffer, keep_all, block_cap)
        fail("select_candidates took slots of rows the plan keeps in one "
             "block")
    except ValueError as e:
        if "stage_candidates" not in str(e):
            fail(f"select_candidates refused one-block rows with {e}")
    staged, _ = stage_candidates(bases, k, hit_buffer, keep_all, seed, thr,
                                 block_cap)

    library = build_library([staged], config.kmer_min_multiplicity,
                            config.kmer_sample_fraction, seed)
    signs, mags = build_precompute_signs(
        library.counts, config.embedding_dimension, config.projection_seed,
        config.projection_density)
    r = staged.shape[0]
    ids = torch.arange(r, dtype=torch.int64, device=dev)
    targets = torch.stack([2 * ids, 2 * ids + 1], dim=1)
    out = torch.zeros((2 * r, config.embedding_dimension), device=dev)
    out_p = torch.zeros_like(out)
    n_hits = membership_embed(staged, library.codes, signs, mags, targets, out)
    n_hits_p = _membership_embed_plain(staged, library.codes, signs, mags,
                                       targets, out_p)
    if not torch.equal(n_hits, n_hits_p):
        fail("membership_embed hit counts differ from its plain version")
    atol = 1e-6 * float(mags.abs().max()) * max(int(n_hits.max()), 1)
    err = float((out - out_p).abs().max())
    if not (torch.isfinite(out).all()
            and torch.allclose(out, out_p, rtol=1e-5, atol=atol)):
        fail(f"membership_embed differs from its plain version: max abs "
             f"error {err} (atol {atol})")
    d = config.embedding_dimension
    distinct, adds = embed_work(staged, library.codes, signs, d)
    log(f"membership_embed: library {library.size} k-mers, "
        f"mean hits/row {float(n_hits.float().mean()):.1f}, "
        f"{distinct} distinct library rows hit, {adds} float32 adds "
        f"(nonzero sign fields of the hit rows); max abs error "
        f"{err} (atol {atol})")
    # bytes: staged rows, targets, the library, the distinct sign rows and
    # magnitudes hit; out's rows and n_hits written
    embed_bytes = (nbytes(staged, targets, library.codes, out, n_hits)
                   + distinct * (signs.shape[1] * 4 + 4))
    report["membership_embed"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: membership_embed(staged, library.codes, signs,
                                              mags, targets, out), 10),
        plain_ms=time_cuda(lambda: _membership_embed_plain(
            staged, library.codes, signs, mags, targets, out_p), 3),
        library_ms=None, **bound(embed_bytes, adds))
    # where kernel C's time goes: at d = 32 the accumulation is 1/16 of
    # d = 512's, so its time is mostly the lookups and the compaction
    signs32, mags32 = build_precompute_signs(
        library.counts, 32, config.projection_seed, config.projection_density)
    out32 = torch.zeros((2 * r, 32), device=dev)
    membership_embed(staged, library.codes, signs32, mags32, targets, out32)
    out32_p = torch.zeros_like(out32)
    _membership_embed_plain(staged, library.codes, signs32, mags32, targets,
                            out32_p)
    if not torch.allclose(out32, out32_p, rtol=1e-5, atol=1e-6 * float(
            mags32.abs().max()) * max(int(n_hits.max()), 1)):
        fail("membership_embed at d = 32 differs from its plain version")
    ms32 = time_cuda(lambda: membership_embed(
        staged, library.codes, signs32, mags32, targets, out32), 10)
    log(f"membership_embed split: d=32 {ms32:.4f} ms, d={d} "
        f"{report['membership_embed']['ms']:.4f} ms per call; device us "
        f"per launch: d=32 " + device_us(lambda: membership_embed(
            staged, library.codes, signs32, mags32, targets, out32), 10,
            True) + f", d={d} " + device_us(lambda: membership_embed(
                staged, library.codes, signs, mags, targets, out), 10, True)
        + f" [{card}]")
    report.update(check_dense(staged, library, targets, config, out_dir,
                              dev, card))
    return report


def check_dense_case(label: str, staged, lib_codes, p_pair, targets,
                     card: str) -> dict:
    """Kernel C's dense form against its plain version on one chunk:
    hit counts bitwise, sums to rtol 1e-5, atol 1e-6 * max|P| * hits (a
    float32 table, or bfloat16 rows whose nonzeros share one magnitude, so
    the plain version's gl +- gr are exact: float32 sums in another order).
    Logs its time, device us a launch and bound (each distinct library row
    hit read once; every hit's row read, no reuse, as an upper figure) and
    F.embedding_bag over the same hit rows, the accumulation half alone.
    Returns its report (library_ms None: no one call does both halves)."""
    import torch
    import torch.nn.functional as F

    from fedrann_tpu_torch.kmers.membership import read_hits_staged
    from fedrann_tpu_torch.project.embed import (
        _membership_embed_dense_plain,
        membership_embed_dense,
    )

    r, d = staged.shape[0], p_pair.shape[1] // 2
    out = torch.zeros((2 * r, d), device=staged.device)
    out_p = torch.zeros_like(out)
    before = membership_embed_dense.launches
    n_hits = membership_embed_dense(staged, lib_codes, p_pair, targets, out)
    torch.cuda.synchronize()
    if membership_embed_dense.launches != before + 1:
        fail(f"{label}: the dense form did not launch")
    n_hits_p = _membership_embed_dense_plain(staged, lib_codes, p_pair,
                                             targets, out_p)
    if not torch.equal(n_hits, n_hits_p):
        fail(f"{label}: hit counts differ from the plain version")
    again = torch.zeros_like(out)
    membership_embed_dense(staged, lib_codes, p_pair, targets, again)
    if not torch.equal(again.view(torch.int32), out.view(torch.int32)):
        fail(f"{label}: two launches of the dense form wrote other bytes")
    del again
    atol = 1e-6 * float(p_pair.float().abs().max()) * max(
        int(n_hits.max()), 1)
    err = float((out - out_p).abs().max())
    if not (torch.isfinite(out).all()
            and torch.allclose(out, out_p, rtol=1e-5, atol=atol)):
        fail(f"{label} differs from its plain version: max abs error "
             f"{err} (atol {atol})")
    lib_size = lib_codes.shape[0]
    hits, _ = read_hits_staged(staged, lib_codes)
    rows = torch.where(hits >= lib_size, hits - lib_size, hits)  # 2L -> L
    n_hit = int((hits < 2 * lib_size).sum())
    distinct = int(torch.unique(rows[hits < 2 * lib_size]).numel())
    row_bytes = 2 * d * p_pair.element_size()
    fixed = nbytes(staged, targets, lib_codes, out, n_hits)
    b = bound(fixed + distinct * row_bytes, n_hit * 2 * d)
    no_reuse = bound(fixed + n_hit * row_bytes)["bound_ms"]

    def kernel():
        return membership_embed_dense(staged, lib_codes, p_pair, targets,
                                      out)

    rep = dict(max_abs_err=err, ms=time_cuda(kernel, 10),
               plain_ms=time_cuda(lambda: _membership_embed_dense_plain(
                   staged, lib_codes, p_pair, targets, out_p), 3),
               library_ms=None, **b)
    bag_ms = time_cuda(lambda: F.embedding_bag(rows, p_pair, mode="sum"), 10)
    log(f"{label}: rows {tuple(staged.shape)}, library {lib_size}, d={d} "
        f"{p_pair.dtype}; {n_hit} hits on {distinct} distinct rows; max abs "
        f"error {err} (atol {atol}); {rep['ms']:.4f} ms vs plain "
        f"{rep['plain_ms']:.4f} ms, device {device_us(kernel, 10, True)} us "
        f"per launch; bound {rep['bound_ms']:.5f} ms ({rep['bound_by']}, "
        f"{100 * rep['bound_ms'] / rep['ms']:.1f}% of it; every hit's row "
        f"read: {no_reuse:.5f} ms, {100 * no_reuse / rep['ms']:.1f}%) "
        f"[{card}]")
    log(f"{label}: F.embedding_bag(mode='sum') over the same hit rows (the "
        f"accumulation half alone, no half swap, no lookups): {bag_ms:.4f} "
        f"ms [{card}]")
    return rep


def golden_config(name: str, out_dir: str):
    """tests/test_golden_parity.py's run on bench/golden/<name>: the
    reference's library and projection imported, 20 neighbors."""
    from fedrann_tpu_torch.cli import config_from_args

    data = os.path.join(HERE, "bench", "golden", name)
    meta = os.path.join(data, "meta.json")
    k = 15
    if os.path.exists(meta):
        with open(meta) as f:
            k = int(json.load(f)["k"])
    return config_from_args([
        "-i", os.path.join(data, "reads.fasta.gz"), "-o", out_dir,
        "-k", str(k),
        "--import-library", os.path.join(data, "fwd_kmer_library.fasta"),
        "--import-projection", os.path.join(data, "precompute.npz"),
        "--nndescent-n-neighbors", "20", "--seed", "20260817"])


def check_dense(staged, library, targets, config, out_dir: str, dev,
                card: str) -> dict:
    """Phase 3b: kernel C's dense form at the main path's chunk with the
    float32 and bfloat16 tables build_precompute_paired builds there, then
    at the first staging chunk of each golden dataset's fullest bucket
    (d = 256, the
    imported float32 table, k = 15 and 21, keep_all). The report is the
    float32 case's."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.compat import load_reference_library_mapping
    from fedrann_tpu_torch.kmers.codec import sample_threshold
    from fedrann_tpu_torch.kmers.library import KmerLibrary
    from fedrann_tpu_torch.kmers.membership import stage_candidates
    from fedrann_tpu_torch.project.srp import build_precompute_paired

    report = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        p_pair = build_precompute_paired(
            library.counts, config.embedding_dimension,
            config.projection_seed, config.projection_density, dtype=dtype)
        rep = check_dense_case(f"membership_embed_dense {name}", staged,
                               library.codes, p_pair, targets, card)
        if name == "f32":
            report["membership_embed_dense"] = rep
        else:
            log_kernel("membership_embed_dense_bf16", rep, card)
        del p_pair
    for name in GOLDEN:
        cfg = golden_config(name, os.path.join(out_dir, name))
        packed = pipeline.load_reads(cfg, dev)
        bucket = max(packed.buckets, key=lambda b: b.read_index.shape[0])
        rows = pipeline.chunk_rows(bucket.length, bucket.read_index.shape[0],
                                   cfg)
        hit_buffer, keep_all, block_cap = pipeline.staging_params(
            bucket.length, cfg)
        if not keep_all:
            fail(f"golden {name}: an imported library must stage keep_all")
        staged_g, _ = stage_candidates(
            pipeline.upload_bucket(bucket, dev)[:rows], cfg.kmer_size,
            hit_buffer, keep_all, cfg.seed,
            sample_threshold(cfg.kmer_sample_fraction), block_cap)
        lib, perm = load_reference_library_mapping(cfg.import_library,
                                                   cfg.kmer_size)
        lib = KmerLibrary(codes=lib.codes.to(dev), counts=lib.counts.to(dev))
        p_pair = pipeline.build_projection(cfg, lib, perm, dev)
        ids = torch.arange(staged_g.shape[0], dtype=torch.int64, device=dev)
        log_kernel(f"membership_embed_dense_golden_{name}", check_dense_case(
            f"membership_embed_dense golden {name} (k={cfg.kmer_size})",
            staged_g, lib.codes, p_pair,
            torch.stack([2 * ids, 2 * ids + 1], dim=1), card), card)
    return report


def check_long_rows(sim, fasta: str, out_dir: str, dev, card: str) -> dict:
    """Phase 5a: at the first staging chunk of the 262,144-base bucket (5%
    sampling) and at a keep_all chunk of the 32,768-base bucket, kernel B's
    device-memory path against its plain version, bitwise: on the path the
    plan picks for the keep_all chunk, and forced (the plan for less shared
    memory) for the 262,144-base rows, which the plan keeps in one block
    and stages fused; there the fused kernel is checked and timed beside
    it. Each chunk's report is the device-memory path's."""
    import numpy as np
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.device import shared_memory_limit
    from fedrann_tpu_torch.io.fastx import FastxRecord
    from fedrann_tpu_torch.io.packing import pack_reads
    from fedrann_tpu_torch.kmers.codec import (
        canonical_sample,
        sample_threshold,
    )
    from fedrann_tpu_torch.kmers.membership import (
        _select_candidates_plain,
        _select_on_card,
        select_candidates,
        stage_launch_plan,
    )

    config = config_from_args(["-i", fasta, "-o", out_dir, *FLAGS])
    packed = pack_reads([FastxRecord(n, q) for n, q in
                         zip(sim.names, sim.sequences)], None)
    log("long-read buckets: "
        + ", ".join(f"{b.length} x {b.bases.shape[0]} rows"
                    for b in packed.buckets))
    bucket = max(packed.buckets, key=lambda b: b.length)
    k, seed = config.kmer_size, config.seed
    thr = sample_threshold(config.kmer_sample_fraction)
    keep_all_rows = pipeline.chunk_rows(KEEP_ALL_BUCKET, 1 << 20, config)
    rng = np.random.default_rng(SIM_SEED)
    keep_all_bases = rng.integers(0, 4, (keep_all_rows, KEEP_ALL_BUCKET),
                                  dtype=np.uint8)
    cases = [("select_candidates_262144", bucket.bases, config),
             ("select_candidates_long", keep_all_bases,
              config_from_args(["-i", fasta, "-o", out_dir, *FLAGS,
                                "--kmer-sample-fraction", "1.0"]))]
    limit = shared_memory_limit(dev)
    report = {}
    for name, bases_np, cfg in cases:
        length = bases_np.shape[1]
        rows = pipeline.chunk_rows(length, bases_np.shape[0], cfg)
        bases = torch.from_numpy(bases_np[:rows]).to(dev)
        hit_buffer, keep_all, block_cap = pipeline.staging_params(length, cfg)
        plan = stage_launch_plan(length - k + 1, hit_buffer, keep_all,
                                 block_cap, limit)
        slots = canonical_sample(bases, k, seed, thr, keep_all)
        staged_p, dropped_p = _select_candidates_plain(slots, hit_buffer,
                                                       keep_all, block_cap)
        # rows kept in one block: the device-memory path the plan would
        # pick with less shared memory
        p = plan if plan.long else stage_launch_plan(
            length - k + 1, hit_buffer, keep_all, block_cap, plan.smem - 8)
        before = select_candidates.long_launches
        staged, dropped = (
            select_candidates(slots, hit_buffer, keep_all, block_cap)
            if plan.long else _select_on_card(slots, hit_buffer, p))
        torch.cuda.synchronize()
        if select_candidates.long_launches != before + 1:
            fail(f"{name}: kernel B's device-memory path did not launch")
        if not (torch.equal(staged, staged_p)
                and torch.equal(dropped, dropped_p)):
            fail(f"{name}: kernel B's device-memory path differs from its "
                 f"plain version in {int((staged != staged_p).sum())} slots "
                 f"and {int((dropped != dropped_p).sum())} dropped counts")
        ms = time_cuda(lambda: _select_on_card(slots, hit_buffer, p), 10)
        dev_us = device_us(lambda: _select_on_card(slots, hit_buffer, p), 10,
                           True)
        log(f"{name}: rows {tuple(slots.shape)} keep_all={keep_all} "
            f"hit_buffer={hit_buffer} block_cap={block_cap}; device-memory "
            f"path{'' if plan.long else ' (forced)'}, passes "
            f"{[q for q, _ in p.passes]}, chunk {p.chunk} x {p.n_chunks}; "
            f"bitwise equal, dropped {int(dropped.sum())}; {ms:.4f} ms, "
            f"device {dev_us} us per launch [{card}]")
        if not plan.long:  # the pipeline stages these rows fused
            log(f"{name}: the plan keeps these rows in one block "
                f"({plan.smem} B of shared memory)")
            log_kernel("stage_rows_262144", check_stage_rows(
                "stage_rows_262144", bases, k, hit_buffer, keep_all, seed,
                thr, block_cap, card), card)
            check_sources("262,144 chunk", bases, torch.from_numpy(
                bucket.lengths[:rows]).to(dev), k, hit_buffer, keep_all,
                seed, thr, block_cap, card)
        report[name] = dict(
            max_abs_err=0.0, ms=ms,
            plain_ms=time_cuda(lambda: _select_candidates_plain(
                slots, hit_buffer, keep_all, block_cap), 3),
            library_ms=time_cuda(lambda: torch.sort(
                slots, dim=1).values[:, :hit_buffer], 10)
            if keep_all else None,
            **bound(nbytes(slots, staged, dropped)))
        log_kernel(name, report[name], card)
    if not stage_launch_plan(KEEP_ALL_BUCKET - k + 1, KEEP_ALL_BUCKET - k + 1,
                             True, None, limit).long:
        fail("keep_all rows of the 32,768-base bucket fit one block: the "
             "device-memory path has no case here")
    return report


def check_keep_all_rows(sim, flags: list[str], dev, card: str) -> None:
    """Phase 5c, first half: on the first chunk of each bucket of the
    keep_all reads that the plan stages through kernel A and kernel B's
    device-memory path (as the CLI packs it, padding included),
    check_sources: A and that path from the byte, packed and bits sources
    (the bits source's copy with INVALID bases across a block edge, in a
    block's halo and at a block's start) against their plain versions,
    bitwise, with A's time and bound from each source."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.device import shared_memory_limit
    from fedrann_tpu_torch.io.fastx import FastxRecord
    from fedrann_tpu_torch.io.packing import pack_reads
    from fedrann_tpu_torch.kmers.codec import sample_threshold
    from fedrann_tpu_torch.kmers.membership import stage_launch_plan

    config = config_from_args(["-i", "-", "-o", "-", *flags])
    k, seed = config.kmer_size, config.seed
    thr = sample_threshold(config.kmer_sample_fraction)
    packed = pack_reads([FastxRecord(n, q) for n, q in
                         zip(sim.names, sim.sequences)], None)
    checked = []
    for bucket in packed.buckets:
        length = bucket.length
        hit_buffer, keep_all, block_cap = pipeline.staging_params(length,
                                                                  config)
        if not stage_launch_plan(length - k + 1, hit_buffer, keep_all,
                                 block_cap, shared_memory_limit(dev)).long:
            continue
        rows = pipeline.chunk_rows(length, bucket.bases.shape[0], config)
        bases = torch.from_numpy(bucket.bases[:rows]).to(dev)
        log(f"keep_all {length}-base bucket: rows {tuple(bases.shape)}, "
            f"{int((bases < 4).sum())} valid bases")
        check_sources(f"keep_all {length} chunk", bases, torch.from_numpy(
            bucket.lengths[:rows]).to(dev), k, hit_buffer, keep_all, seed,
            thr, block_cap, card)
        checked.append(length)
    if not checked:
        fail("no bucket of the keep_all reads takes kernel A")


def leading_float(text: str) -> float | None:
    """The number a device_us text starts with, or None (not measured)."""
    try:
        return float(text.split()[0])
    except ValueError:
        return None


def smem_input_every_step(x):
    """Every step's sum from fk_probe_smem_input (n_sums = steps), launched
    through its C entry (the wrapper asks for the last step's only), and
    the plain version's, taken step by step."""
    import torch

    from fedrann_tpu_torch import _build, probes

    steps = x.shape[0] // probes.INPUT_ROWS
    sums = torch.empty(steps, dtype=torch.int32, device=x.device)
    _build.launch("fk_probe_smem_input", x.data_ptr(), steps,
                  probes.INPUT_ROWS, x.shape[1], sums.data_ptr(), steps,
                  device=x.device)
    return sums, torch.cat([probes._smem_input_plain(blk)
                            for blk in x.split(probes.INPUT_ROWS)])


def check_smem_input(x, dev) -> None:
    """P2/P5 beyond the probe inputs: every step's sum, bitwise against the
    plain version, at the probe inputs and at full-range random int32
    blocks (sums that wrap), aligned and off 16 bytes (4-byte loads)."""
    import numpy as np
    import torch

    from fedrann_tpu_torch import probes

    info = np.iinfo(np.int32)
    xr = torch.from_numpy(np.random.default_rng(SIM_SEED).integers(
        info.min, info.max, x.shape, dtype=np.int32, endpoint=True)).to(dev)
    flat = torch.zeros(xr.numel() + 1, dtype=torch.int32, device=dev)
    flat[1:].copy_(xr.view(-1))
    off16 = flat[1:].view(xr.shape)  # 4 bytes past a 16-byte boundary
    sums = {}
    for what, xs in (("probe inputs", x), ("full range", xr),
                     ("full range off 16 bytes", off16)):
        got, sums[what] = smem_input_every_step(xs)
        if not torch.equal(got, sums[what]):
            fail(f"P2/P5 step sums on the {what} differ from the plain "
                 f"version in {int((got != sums[what]).sum())} steps")
    wide = xr.view(-1, probes.INPUT_ROWS, x.shape[1]).to(torch.int64)
    i = torch.arange(probes.INPUT_ROWS, device=dev)
    wrapped = int((wide[:, i, i & 1023].sum(dim=1)
                   != sums["full range"]).sum())
    if wrapped == 0:
        fail("P2/P5: no full-range step sum wrapped past int32")
    log(f"P2/P5: every step's sum bitwise at the probe inputs and at "
        f"full-range int32 blocks, aligned and off 16 bytes ({wrapped} of "
        f"{xr.shape[0] // probes.INPUT_ROWS} step sums wrap)")


def check_bsearch_edges(dev) -> None:
    """P4 beyond the probe inputs: on each of probes.bsearch_edge_cases'
    tables every query launched alone (nq = 1) against torch.searchsorted,
    then all of them together with random queries (nq not a multiple of a
    block's round) on the table and on a copy of it off 16 bytes; and
    372,737 queries, past one round of one block per SM, at the probe
    table. Sums bitwise against the plain version."""
    import numpy as np
    import torch

    from fedrann_tpu_torch import probes

    rng = np.random.default_rng(SIM_SEED)
    for tab_np, q_np in probes.bsearch_edge_cases():
        tab = torch.from_numpy(tab_np).to(dev)
        q = torch.from_numpy(q_np).to(dev)
        want = torch.searchsorted(tab, q, side="left")
        for j in range(q.shape[0]):
            got = int(probes.bsearch(tab, q[j : j + 1])[0])
            if got != int(want[j]):
                fail(f"P4 on a table of {tab.shape[0]}: query {int(q[j])} "
                     f"at {got}, lower bound {int(want[j])}")
        qs = torch.cat([q, torch.from_numpy(rng.integers(
            int(tab_np[0]) - 9, int(tab_np[-1]) + 9, 1001).astype(
                np.int32)).to(dev)])
        flat = torch.zeros(tab.shape[0] + 1, dtype=torch.int32, device=dev)
        flat[1:].copy_(tab)
        for t_, label in ((tab, "aligned"), (flat[1:], "off 16 bytes")):
            got, want_sum = (probes.bsearch(t_, qs),
                             probes._bsearch_plain(t_, qs))
            if not torch.equal(got, want_sum):
                fail(f"P4 on a table of {tab.shape[0]} ({label}), "
                     f"{qs.shape[0]} queries: {int(got[0])}, plain "
                     f"{int(want_sum[0])}")
    table = torch.from_numpy(probes.probe_inputs()["table"]).to(dev)
    many = torch.from_numpy(rng.integers(0, 1 << 30, 372_737).astype(
        np.int32)).to(dev)
    if not torch.equal(probes.bsearch(table, many),
                       probes._bsearch_plain(table, many)):
        fail("P4 past one round of blocks differs from the plain version")
    log("P4: every edge query alone equals torch.searchsorted; batches "
        "(aligned, off 16 bytes, 372,737 queries) equal the plain version")


def bsearch_floor(table, queries, dev_us: str, card: str) -> str:
    """P4's latency floor beside its device time: its own kernel on one
    query (nq = 1: the launch, one 32 KB table copy into one SM and one
    search), the least a launch can take, with that search's part priced:
    log2(P) dependent shared-memory loads (P the power of two >= n + 1) at
    the clock cycles one takes (fk_smem_chase_cycles, a chain of 4,096)
    over the card's max SM clock as nvidia-smi reports it."""
    import torch

    from fedrann_tpu_torch import _build, probes

    dev = table.device
    cycles = torch.zeros(2, dtype=torch.int64, device=dev)
    _build.launch("fk_smem_chase_cycles", 4096, cycles.data_ptr(),
                  device=dev)
    latency = int(cycles[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    try:
        mhz = float(smi.stdout.split()[0])
    except (IndexError, ValueError):
        fail(f"P4 floor: nvidia-smi gave no max SM clock ({smi.stdout!r} "
             f"{smi.stderr!r})")
    steps = table.shape[0].bit_length()
    chain_us = steps * latency / mhz
    one = queries[:1]
    if not torch.equal(probes.bsearch(table, one),
                       probes._bsearch_plain(table, one)):
        fail("P4 on one query differs from the plain version")
    one_us = device_us(lambda: probes.bsearch(table, one), 20, True)
    floor, full = leading_float(one_us), leading_float(dev_us)
    ratio = ("" if floor is None or full is None
             else f", {full / floor:.2f}x the floor")
    return (f"P4 latency floor: its kernel on one query {one_us} us per "
            f"launch (the launch, one 32 KB table copy into one SM, one "
            f"search of {steps} dependent shared-memory loads x {latency} "
            f"cycles (a chain of 4,096) at {mhz:.0f} MHz = {chain_us:.3f} "
            f"us); byte bound 0.00003 ms; device {dev_us} us per launch at "
            f"{queries.shape[0]} queries{ratio} [{card}]")


def input_host_split(x) -> dict:
    """Host microseconds of each piece of P2/P5's per-call path at the
    probe inputs: the input checks, the output allocation (a shape tuple
    of `steps`, or one int), the `sums[-1:]` slice, the data pointer, the
    stream handle, the C entry point alone, `_build.launch` without and
    with the device guard, the parent's wrapper (its steps replayed on
    this C entry), the wrapper, and the plain version for comparison."""
    import torch

    from fedrann_tpu_torch import _build, probes

    steps, hb = x.shape[0] // probes.INPUT_ROWS, x.shape[1]
    sums = torch.empty(steps, dtype=torch.int32, device=x.device)
    args = (x.data_ptr(), steps, probes.INPUT_ROWS, hb, sums.data_ptr(), 1,
            _build.stream(x.device))
    entry = _build.kernels().fk_probe_smem_input

    def checks():
        if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError
        rows, hb = x.shape
        return rows % probes.INPUT_ROWS or hb < probes.INPUT_ROWS

    def before():  # the parent's wrapper: (steps,) sums, then a slice
        probes._check_int32(x)
        if x.dim() != 2 or x.shape[0] % 16 or x.shape[1] < 16:
            raise ValueError
        if x.device.type == "cpu":
            raise ValueError
        n = x.shape[0] // probes.INPUT_ROWS
        out = torch.empty((n,), dtype=torch.int32, device=x.device)
        _build.launch("fk_probe_smem_input", x.data_ptr(), n,
                      probes.INPUT_ROWS, x.shape[1], out.data_ptr(), n,
                      _build.stream(x.device))
        return out[-1:]

    return {
        "checks": host_us(checks),
        "empty_tuple": host_us(lambda: torch.empty(
            (steps,), dtype=torch.int32, device=x.device)),
        "empty_int": host_us(lambda: torch.empty(
            1, dtype=torch.int32, device=x.device)),
        "slice": host_us(lambda: sums[-1:]),
        "data_ptr": host_us(x.data_ptr),
        "stream": host_us(lambda: _build.stream(x.device)),
        "c_call": host_us(lambda: entry(*args)),
        "launch unguarded": host_us(lambda: _build.launch(
            "fk_probe_smem_input", *args)),
        "launch": host_us(lambda: _build.launch(
            "fk_probe_smem_input", *args[:-1], device=x.device)),
        "wrapper before": host_us(before),
        "wrapper": host_us(lambda: probes.smem_input(x)),
        "plain": host_us(lambda: probes._smem_input_plain(x)),
    }


def bsearch_host_split(table, queries) -> dict:
    """Host microseconds of each piece of P4's per-call path at the probe
    inputs: the input checks, the output allocation (zero-filled, or
    empty), the data pointers, the stream handle, the C entry point alone
    (which zeroes the output on the stream), `_build.launch` without and
    with the device guard, the parent's wrapper (its steps replayed), the
    wrapper, and the plain version."""
    import torch

    from fedrann_tpu_torch import _build, probes

    dev = table.device
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (table.data_ptr(), table.shape[0], queries.data_ptr(),
            queries.shape[0], out.data_ptr(), _build.stream(dev))
    entry = _build.kernels().fk_probe_bsearch

    def before():  # the parent's wrapper: a zero-filled output
        probes._check_int32(table, queries)
        if table.device.type == "cpu":
            raise ValueError
        out = torch.zeros((1,), dtype=torch.int32, device=table.device)
        _build.launch("fk_probe_bsearch", table.data_ptr(), table.shape[0],
                      queries.data_ptr(), queries.shape[0], out.data_ptr(),
                      _build.stream(table.device))
        return out

    return {
        "checks": host_us(lambda: probes._check_int32(table, queries)),
        "zeros_tuple": host_us(lambda: torch.zeros(
            (1,), dtype=torch.int32, device=dev)),
        "empty_int": host_us(lambda: torch.empty(
            1, dtype=torch.int32, device=dev)),
        "data_ptrs": host_us(lambda: (table.data_ptr(), queries.data_ptr())),
        "stream": host_us(lambda: _build.stream(table.device)),
        "c_call": host_us(lambda: entry(*args)),
        "launch unguarded": host_us(lambda: _build.launch(
            "fk_probe_bsearch", *args)),
        "launch": host_us(lambda: _build.launch(
            "fk_probe_bsearch", *args[:-1], device=dev)),
        "wrapper before": host_us(before),
        "wrapper": host_us(lambda: probes.bsearch(table, queries)),
        "plain": host_us(lambda: probes._bsearch_plain(table, queries)),
    }


def check_probes(dev, card: str) -> dict:
    """Phase 6, first half: each probe kernel against its plain version on
    the card, at the probe scripts' inputs."""
    import torch

    from fedrann_tpu_torch import probes
    from fedrann_tpu_torch.device import shared_memory_limit

    host = {k: torch.from_numpy(v) for k, v in probes.probe_inputs().items()}
    t = {k: v.to(dev) for k, v in host.items()}
    limit = shared_memory_limit(dev)
    steps = probes.probe_smem_scratch(dev)
    problems = probes.scratch_ladder_problems(steps, limit)
    if problems:
        fail(f"P1 against the {limit}-byte opt-in limit: {problems}")
    n_max = max(s.n for s in steps if s.error is None)
    log(f"P1: accepted {[s.n * 4 // 1024 for s in steps if s.error is None]}"
        f" KB, refused {steps[-1].n * 4 // 1024} KB "
        f"({steps[-1].error}); opt-in limit {limit} B")
    report = {"fk_probe_smem_scratch": dict(
        max_abs_err=0.0,
        ms=time_cuda(lambda: probes.smem_scratch(n_max, dev), 20),
        plain_ms=time_cuda(lambda: probes._smem_scratch_plain(n_max, dev),
                           20),
        library_ms=time_cuda(lambda: torch.full(
            (1, 1), n_max, dtype=torch.int32, device=dev), 20),
        **bound(4))}
    for n in (probes.SCRATCH_SIZES[0], n_max):
        dev_us = device_us(lambda n=n: probes.smem_scratch(n, dev), 20, True)
        plain_us = device_us(lambda n=n: probes._smem_scratch_plain(n, dev),
                             20, False)
        split = p1_host_split(dev, n)
        log(f"P1 {n * 4 // 1024} KB: device {dev_us} us per launch "
            f"(plain {plain_us}); host us per call: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" [{card}]")

    x = t["x"]
    got, want = probes.smem_input(x), probes._smem_input_plain(x)
    if not torch.equal(got, want) or int(got[0]) != 1818744:
        fail(f"P2/P5 smem_input {int(got[0])}, plain {int(want[0])}")
    check_smem_input(x, dev)
    report["fk_probe_smem_input"] = dict(
        max_abs_err=0.0, ms=time_cuda(lambda: probes.smem_input(x), 20),
        plain_ms=time_cuda(lambda: probes._smem_input_plain(x), 20),
        library_ms=None,
        **bound(nbytes(x) + 4 * (x.shape[0] // probes.INPUT_ROWS)))
    log("P2/P5 smem_input: device " + device_us(
        lambda: probes.smem_input(x), 20, True) + " us vs plain "
        + device_us(lambda: probes._smem_input_plain(x), 20, False)
        + " us per call; host us per call: " + ", ".join(
            f"{k} {v:.3f}" for k, v in input_host_split(x).items())
        + f" [{card}]")

    q, idx, row = t["q"], t["idx"], t["row"]
    qmax = float(q.abs().max())
    hits_per_row = int(torch.bincount(row.long()).max())
    worst = 0.0
    e_lib = torch.zeros((probes.E_ROWS, q.shape[1]), device=dev)
    gathered = q[idx.long()]
    library = {  # one PyTorch call per mode, the source rows gathered first
        "P3": lambda: e_lib.index_add_(0, row.long(), gathered, alpha=2.0),
        "A": lambda: e_lib.index_add_(0, torch.zeros_like(row.long()),
                                      q[:1].expand(idx.shape[0], -1)),
        "B": lambda: e_lib.index_put_((row.long(),), q[:1].expand(
            idx.shape[0], -1)),
        "C": lambda: e_lib.index_add_(0, row.long(), gathered),
    }
    for mode, (_, dst_dyn, _, steps_) in sorted(probes.DYN_MODES.items()):
        got = probes.dyn_rows(q, idx, row, mode)
        replay = probes._dyn_rows_replay(host["q"], host["idx"], host["row"],
                                         mode)
        if not torch.equal(got.cpu(), replay):
            fail(f"dyn_rows mode {mode} differs from the hit-order replay "
                 f"in {int((got.cpu() != replay).sum())} cells")
        want = probes._dyn_rows_plain(q, idx, row, mode)
        err = float((got - want).abs().max())
        if mode == "B":
            ok = torch.equal(got, want)
        else:
            terms = steps_ * (hits_per_row if dst_dyn else idx.shape[0])
            ok = torch.allclose(got, want, rtol=1e-5,
                                atol=1e-6 * terms * qmax)
        if not (ok and torch.isfinite(got).all()):
            fail(f"dyn_rows mode {mode} differs from its plain version: "
                 f"max abs error {err}")
        worst = max(worst, err)
        ms = time_cuda(lambda m=mode: probes.dyn_rows(q, idx, row, m), 20)
        plain_ms = time_cuda(
            lambda m=mode: probes._dyn_rows_plain(q, idx, row, m), 20)
        dev_us = device_us(lambda m=mode: probes.dyn_rows(q, idx, row, m),
                           20, True)
        plain_us = device_us(
            lambda m=mode: probes._dyn_rows_plain(q, idx, row, m), 20, False)
        lib_ms = time_cuda(library[mode], 20)
        log(f"dyn_rows {mode}: bitwise equal to the hit-order replay; max "
            f"abs error against plain {err}; {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms vs library {lib_ms:.4f} ms per call, device "
            f"{dev_us} us vs plain {plain_us} us per call [{card}]")
    steps_p3 = probes.DYN_MODES["P3"][3]
    report["fk_probe_dyn_rows"] = dict(
        max_abs_err=worst,
        ms=time_cuda(lambda: probes.dyn_rows(q, idx, row, "P3"), 20),
        plain_ms=time_cuda(lambda: probes._dyn_rows_plain(
            q, idx, row, "P3"), 20),
        library_ms=time_cuda(library["P3"], 20),
        **bound(nbytes(q, idx, row, e_lib),
                steps_p3 * idx.shape[0] * q.shape[1]))

    table, queries = t["table"], t["queries"]
    got, want = probes.bsearch(table, queries), probes._bsearch_plain(
        table, queries)
    if not torch.equal(got, want):
        fail(f"P4 bsearch {int(got[0])}, plain {int(want[0])}")
    check_bsearch_edges(dev)
    report["fk_probe_bsearch"] = dict(
        max_abs_err=0.0,
        ms=time_cuda(lambda: probes.bsearch(table, queries), 20),
        plain_ms=time_cuda(lambda: probes._bsearch_plain(table, queries),
                           20),
        library_ms=None, **bound(nbytes(table, queries) + 4))
    dev_us = device_us(lambda: probes.bsearch(table, queries), 20, True)
    log("P4 bsearch: device " + dev_us + " us vs plain "
        + device_us(lambda: probes._bsearch_plain(table, queries), 20, False)
        + " us per call; host us per call: " + ", ".join(
            f"{k} {v:.3f}" for k, v in bsearch_host_split(
                table, queries).items()) + f" [{card}]")
    log(bsearch_floor(table, queries, dev_us, card))
    for name in probes.WRAPPERS:
        log_kernel(name, report[name], card)
    return report


def drive_probes() -> dict:
    """Phase 6, second half: the probe entry point (`all`) with every
    probe kernel's count reset just before; returns the counts."""
    from fedrann_tpu_torch import probes

    for fn in probes.WRAPPERS.values():
        fn.launches = 0
    rc = probes.main(["all"])
    launches = {name: fn.launches for name, fn in probes.WRAPPERS.items()}
    if rc != 0:
        fail(f"python -m fedrann_tpu_torch.probes all returned {rc}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"probe kernel {name} was not launched by the probe path")
    log(f"probe path launches: {launches}")
    return launches


def stage_kernels(packed, config, dev) -> set[str]:
    """The staging kernels (names in COUNTERS) that the plan and the
    source pick for the buckets of `packed` staged with `config`: the
    fused kernel for a bucket whose rows one block holds, else kernel A
    and kernel B's device-memory path; each window-code kernel on the
    packed source for a bucket without mid-read N (prefix_valid), else on
    the bits source."""
    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.device import shared_memory_limit
    from fedrann_tpu_torch.kmers.membership import stage_launch_plan

    paths = set()
    for b in packed.buckets:
        source = "packed" if b.prefix_valid else "bits"
        paths.update((f"canonical_sample_{source}", "select_candidates_long")
                     if stage_launch_plan(
                         b.length - config.kmer_size + 1,
                         *pipeline.staging_params(b.length, config),
                         shared_memory_limit(dev)).long
                     else (f"stage_rows_{source}",))
    return paths


def stage_paths(sim, flags: list[str], dev) -> set[str]:
    """stage_kernels of `sim`'s reads packed as the pipeline packs them
    with `flags` (a read past the largest bucket split), by the plain
    packer."""
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.io.fastx import FastxRecord
    from fedrann_tpu_torch.io.packing import pack_reads

    config = config_from_args(["-i", "-", "-o", "-", *flags])
    return stage_kernels(pack_reads(
        [FastxRecord(n, q) for n, q in zip(sim.names, sim.sequences)], None,
        split_overlap=config.kmer_size - 1), config, dev)


@contextlib.contextmanager
def no_plain_on_card():
    """Inside: the plain versions of K4 (merge_block_plain, and the IVF
    cluster ranking's top_clusters_plain), K5 (sign_table_plain), K6
    (rescore_plain), K7 (merge_buffers_plain), K8 (paired_table_plain)
    K9 (segment_sum_plain, and _segments, its bucketing's), K10
    (keys_to_host_plain) and K11 (bucket_clusters_plain,
    bucket_units_plain, and the CPU search's member_table_plain and
    probe_tables_plain) fail the run if they are given a CUDA tensor,
    which only this script's reference calls may do."""
    import torch

    from fedrann_tpu_torch.knn import ivf, topk
    from fedrann_tpu_torch.project import srp

    saved = [(topk, "merge_block_plain"), (srp, "sign_table_plain"),
             (srp, "paired_table_plain"), (ivf, "top_clusters_plain"),
             (ivf, "rescore_plain"), (ivf, "merge_buffers_plain"),
             (ivf, "segment_sum_plain"), (ivf, "_segments"),
             (topk, "keys_to_host_plain"), (ivf, "member_table_plain"),
             (ivf, "probe_tables_plain"), (ivf, "bucket_clusters_plain"),
             (ivf, "bucket_units_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]

    def guard(name, fn):
        def guarded(*args, **kwargs):
            device = kwargs.get("device", args[4] if len(args) > 4 else None)
            if name == "sign_table_plain":
                on_card = device is not None and device.type == "cuda"
            else:
                on_card = any(isinstance(a, torch.Tensor)
                              and a.device.type == "cuda" for a in args)
            if on_card:
                fail(f"a CUDA tensor reached {name} in a CLI run")
            return fn(*args, **kwargs)
        return guarded

    for mod, name, fn in saved:
        setattr(mod, name, guard(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_counts() -> None:
    """Every kernel's launch count and every host count to 0."""
    for fn, attr in (*COUNTERS.values(), *HOST_COUNTERS.values()):
        setattr(fn, attr, 0)


def read_counts(table: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in table.items()}


def check_host(host: dict, load: str, what: str) -> None:
    """The host counts of one pipeline run: the Python reader and packer
    never ran; load "parse": one native parse and no pinning copy (the
    packer filled pinned memory), "cache": no parse, one cache load."""
    want = {"read_fastx": 0, "pack_reads": 0}
    if load == "parse":
        want.update(pack_reads_native=1, cache_hits=0, pin_copies=0)
    else:
        want.update(pack_reads_native=0, cache_hits=1)
    wrong = {k: host[k] for k, v in want.items() if host[k] != v}
    if wrong:
        fail(f"{what}: host counts {wrong}, want {want}")


def drive_cli(fasta: str, out_dir: str, sim, min_overlap: int, card: str,
              dev, flags: list[str] = FLAGS,
              embed: str = "membership_embed", load: str = "parse",
              resumed: bool = False, min_recall: float = MIN_RECALL):
    """Run fedrann_tpu_torch.cli.main on `fasta` with `flags` and every
    count reset just before; every kernel must launch, each staging kernel
    exactly when the plan and the source pick it for a bucket of the reads
    (never on the byte source), and of kernel C's two forms `embed` only;
    `resumed` (a rerun over --keep-intermediates checkpoints): no staging
    kernel and no kernel C. The load goes as `load` says (check_host).
    Check overlaps.tsv and the truth recall of pairs overlapping >=
    min_overlap (at least min_recall). Returns the launch counts and the
    stage seconds."""
    paths = set() if resumed else stage_paths(sim, flags, dev)
    from fedrann_tpu_torch.cli import main as cli_main
    from fedrann_tpu_torch.io.tsv import HEADER

    reset_counts()
    n_reads = len(sim.names)
    t0 = time.perf_counter()
    with no_plain_on_card():
        rc = cli_main(["-i", fasta, "-o", out_dir, *flags])
    wall = time.perf_counter() - t0
    launches = read_counts(COUNTERS)
    host = read_counts(HOST_COUNTERS)
    if rc != 0:
        fail(f"cli.main returned {rc}")
    check_launches(launches, paths, None if resumed else embed,
                   "the main path", knn_expected(flags),
                   embed == "membership_embed",
                   not resumed and "--projection-dtype" in flags)
    check_host(host, load, "the main path")
    log(f"main path launches: {launches}; host counts: {host}")

    with open(os.path.join(out_dir, "metrics.json")) as f:
        stages = json.load(f)
    secs = {s: stages[s]["seconds"] for s in STAGES if s in stages}
    log(f"stage seconds [{card}]: "
        + ", ".join(f"{s} {v:.3f}" for s, v in secs.items())
        + f"; load {load}, uploaded "
        f"{stages.get('stage', {}).get('h2d_bytes', 0):.0f} bytes; "
        + roofline(stages))
    log(f"main path: {n_reads} reads in {wall:.2f} s wall = "
        f"{n_reads / wall:.1f} reads/s; device stages (stage..knn) "
        f"{sum(secs.get(s, 0.0) for s in ('stage', 'count', 'project', 'embed', 'knn')):.3f} s "
        f"[{card}]")

    header, per_query = read_overlaps(os.path.join(out_dir, "overlaps.tsv"))
    if header != HEADER.rstrip("\n").split("\t"):
        fail(f"bad overlaps.tsv header {header}")
    n_rows = sum(per_query.values())
    if len(per_query) != 2 * n_reads or not all(
            c in (49, 50) for c in per_query.values()):
        fail(f"overlaps.tsv: {len(per_query)} queries (want "
             f"{2 * n_reads}), rows per query "
             f"{sorted(set(per_query.values()))} (want 50 less self)")
    log(f"overlaps.tsv: {n_rows} rows = {2 * n_reads} x 50 less "
        f"{2 * n_reads * 50 - n_rows} self rows")

    check_truth_recall(os.path.join(out_dir, "overlaps.tsv"), sim,
                       min_overlap, "", min_recall)
    return launches, secs


def check_truth_recall(path: str, sim, min_overlap: int,
                       what: str, floor: float = MIN_RECALL) -> float:
    """The truth recall of an overlaps.tsv (fedrann_tpu_torch.eval
    truth_recall over the pairs of `sim` overlapping >= min_overlap, from
    every row of either read, both orientations); fails below floor."""
    from fedrann_tpu_torch.eval import truth_recall

    truth = sim.truth_overlaps(min_overlap=min_overlap)
    recall = truth_recall(tsv_neighbor_rows(path, sim.names), truth,
                          len(sim.names))
    log(f"{what}truth recall (overlap >= {min_overlap}): {recall:.4f} over "
        f"{len(truth)} pairs")
    if not truth or recall < floor:
        fail(f"{what}truth recall {recall:.4f} below {floor}")
    return recall


def tsv_neighbor_rows(path: str, names: list[str]):
    """An overlaps.tsv as (2R, most neighbors) embedding-row indices, -1
    where a row lists fewer (the self row is not in the table)."""
    import numpy as np

    index = {n: i for i, n in enumerate(names)}
    rows: dict[int, list[int]] = {}
    with open(path) as f:
        f.readline()
        for line in f:
            q, qo, t, to, _rank, _dist = line.rstrip("\n").split("\t")
            rows.setdefault(2 * index[q] + (qo == "-"), []).append(
                2 * index[t] + (to == "-"))
    out = np.full((2 * len(names), max(map(len, rows.values()), default=0)),
                  -1, np.int64)
    for r, ts in rows.items():
        out[r, : len(ts)] = ts
    return out


def roofline(stages: dict) -> str:
    """The knn and embed rates a metrics.json derives from its counters;
    fails where a share of the card's peak passes 100% (the counters then
    count more work than the stage did)."""
    knn, embed = stages.get("knn", {}), stages.get("embed", {})
    for name, pct in (("knn mfu_pct", knn.get("mfu_pct", 0)),
                      ("embed hbm_util_pct", embed.get("hbm_util_pct", 0))):
        if pct > 100:
            fail(f"metrics.json: {name} {pct} is past the card's peak")
    return (f"knn {knn.get('tflops_per_s', 0):.3f} TFLOP/s, mfu "
            f"{knn.get('mfu_pct', 'none')}%; embed "
            f"{embed.get('hbm_gb_per_s', 0):.1f} GB/s, hbm util "
            f"{embed.get('hbm_util_pct', 'none')}%")


def knn_expected(flags: list[str]) -> dict:
    """Which k-NN kernels a CLI run with `flags` must launch (True) and
    which it must not (False): K4 on every search (exact, and the IVF
    searches' k-means and cluster ranking), its fp32 form at
    --knn-precision fp32 where it scores the search (exact in core or out
    of core, and the out-of-core IVF search, whose k-means follows the
    precision; the in-core IVF k-means is bf16 at either precision); K6
    and K7 on the in-core and sharded IVF searches (K6's fp32 form at
    fp32); none of them out of core, which rescores by K4's slab loop; K9
    (the k-means's segment sums) on every IVF search; K11 (the member and
    probe buckets; ivf_buckets_probe its probe sides) where K6 rescores;
    K10 (the result wire) on every search."""
    fp32 = ("--knn-precision" in flags
            and flags[flags.index("--knn-precision") + 1] == "fp32")
    ivf = ("--knn-method" in flags
           and flags[flags.index("--knn-method") + 1] == "ivf")
    rescore = ivf and "--knn-hbm-budget" not in flags
    return {"knn_merge": True, "knn_merge_fp32": fp32 and not rescore,
            "ivf_rescore": rescore, "ivf_rescore_fp32": rescore and fp32,
            "ivf_merge": rescore, "ivf_segment_sum": ivf,
            "ivf_buckets": rescore, "ivf_buckets_probe": rescore,
            "result_wire": True}


def check_launches(launches: dict, paths: set, embed: str | None,
                   what: str, knn: dict | None = None,
                   signs: bool | None = None, paired: bool = False) -> None:
    """Each staging kernel launched exactly where the plan picks its path
    (`paths`), kernel C in the projection's form `embed` only, the k-NN
    kernels as `knn` says (knn_expected's dict; by default the exact
    bf16 search's; K9 three times a k-means, one launch a pass), K5 where
    the projection is the sign table (`signs`; by default where `embed`
    is kernel C's sign form), K8 exactly where it is a dense table built
    from the stream (`paired`: --projection-dtype f32|bf16, not an
    imported one), and every other kernel launched."""
    signs = embed == "membership_embed" if signs is None else signs
    knn = knn_expected([]) if knn is None else knn
    for name, n in launches.items():
        want = (name in paths if name in STAGE_KERNELS
                else name == embed if name in EMBED_KERNELS
                else signs if name == "srp_signs"
                else paired if name == "srp_paired"
                else knn[name] if name in knn else True)
        if (n > 0) != want or (name == "ivf_segment_sum" and n % 3):
            fail(f"kernel {name} was launched {n} times by {what}, "
                 f"expected {'some' if want else 'none'}"
                 + (" (a multiple of 3)" if name == "ivf_segment_sum"
                    else ""))
    check_k11(launches, knn.get("ivf_rescore", False), what)


def check_k11(launches: dict, rescore: bool, what: str) -> None:
    """K11 launched, in one IVF search that K6 rescores, once for the
    member side and once for the probe side of each K6 launch (in core:
    twice), else never."""
    k6 = launches.get("ivf_rescore", 0)
    want = (k6 + 1, k6) if rescore else (0, 0)
    got = (launches.get("ivf_buckets", 0),
           launches.get("ivf_buckets_probe", 0))
    if got != want:
        fail(f"K11 launched {got[0]} times ({got[1]} probe sides) in {what} "
             f"for {k6} K6 launches, want {want[0]} ({want[1]})")


def load_split(fasta: str, out_dir: str, card: str) -> None:
    """Phase 4c, second half: where the main path's load goes, each
    piece on the host clock: the native parse on 1 and 8 threads, the
    parse and pack into pinned and into pageable memory, the cache write
    and the cache load."""
    from fedrann_tpu_torch.io import cache, native

    split = int(FLAGS[FLAGS.index("-k") + 1]) - 1
    secs = {}

    def clock(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    clock("parse (1 thread)", lambda: native.parse_fastx_native(fasta, 1))
    clock("parse (8 threads)", lambda: native.parse_fastx_native(fasta, 8))
    packed = clock("parse + pack, pinned", lambda: native.pack_reads_native(
        fasta, None, split_overlap=split, pin_memory=True))
    clock("parse + pack, pageable", lambda: native.pack_reads_native(
        fasta, None, split_overlap=split))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "fxcache.npz")
    meta = cache.cache_meta(fasta, None, split)
    clock("cache write", lambda: cache.save_packed_cache(path, packed, meta))
    clock("cache load", lambda: cache.load_packed_cache(path, meta))
    log("4c load split: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                      secs.items())
        + f"; fxcache.npz {os.path.getsize(path)} bytes [{card}]")


def check_checkpoints(fasta: str, out_dir: str, sim, card: str, dev) -> None:
    """Phase 4d: the main path with --keep-intermediates, then the same
    again: the rerun loads from the cache, resumes the library and the
    embeddings (no staging kernel, no kernel C) and writes a
    byte-identical overlaps.tsv."""
    flags = [*FLAGS, "--keep-intermediates"]
    drive_cli(fasta, out_dir, sim, MIN_OVERLAP, card, dev, flags)
    ckpt = os.path.join(out_dir, "checkpoints")
    missing = [f for f in ("library.npz", "embeddings.npy",
                           "embeddings_meta.json")
               if not os.path.exists(os.path.join(ckpt, f))]
    if missing:
        fail(f"4d: --keep-intermediates wrote no {missing}")
    tsv = os.path.join(out_dir, "overlaps.tsv")
    with open(tsv, "rb") as f:
        first = f.read()
    launches, secs = drive_cli(fasta, out_dir, sim, MIN_OVERLAP, card, dev,
                               flags, load="cache", resumed=True)
    with open(tsv, "rb") as f:
        if f.read() != first:
            fail("4d: the resumed run's overlaps.tsv differs from the first")
    log(f"4d resumed run: no staging kernel and no kernel C ({launches}); "
        f"load {secs['load']:.3f} s from fxcache.npz; overlaps.tsv "
        f"byte-identical ({len(first)} bytes) [{card}]")


def device_busy_us(trace_path: str) -> tuple[float, int]:
    """(device busy microseconds: the union of the intervals of the
    kernels, copies and sets in a torch.profiler Chrome trace, their
    count)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, cur = 0.0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return busy + (cur[1] - cur[0] if cur else 0.0), len(spans)


def stage_kernels_in_trace(trace_path: str, stage: str) -> list[str]:
    """The names of the kernels a torch.profiler Chrome trace shows inside
    the "stage:<stage>" range (metrics.stage's record_function; the stage
    synchronizes the device at both ends, so its kernels run inside it).
    The range is its device-side copy (gpu_user_annotation), on the
    kernels' own clock, where the trace has one: the host-side range
    (user_annotation) is on the host's clock, which the trace aligns with
    the device's only roughly, and a run was seen whose first knn kernels
    fell before it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = []
    for cat in ("gpu_user_annotation", "user_annotation"):
        spans = spans or [(e["ts"], e["ts"] + e.get("dur", 0))
                          for e in events
                          if e.get("ph") == "X"
                          and e.get("name") == f"stage:{stage}"
                          and e.get("cat") == cat]
    if not spans:
        fail(f"4e: the trace has no stage:{stage} range")
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and any(a <= e["ts"] <= b for a, b in spans)]


def check_stage_kernels(trace: str, card: str) -> None:
    """Phase 4e's trace: the exact knn runs K4 and no library GEMM or
    top-k kernel; the project stage runs K5 and no int64 elementwise chain
    (at most the two kernels that turn the L counts into ICF weights)."""
    knn = stage_kernels_in_trace(trace, "knn")
    project = stage_kernels_in_trace(trace, "project")
    library = [n for n in knn if any(
        w in n.lower() for w in ("gemm", "cutlass", "xmma", "topk",
                                 "sort", "cublas"))]
    int64 = [n for n in project if "elementwise" in n and (
        "long" in n or "int64" in n)]
    def names(kernels):
        cut = [n.removeprefix("void ") for n in kernels]
        return sorted({n[: n.find("(", 1)][:90] for n in cut})

    log(f"4e trace: {len(knn)} knn stage kernels {names(knn)}; "
        f"{len(project)} project stage kernels {names(project)} [{card}]")
    if not any(is_hand(n) and "knn_merge" in n for n in knn) or library:
        fail(f"4e: the knn stage ran {knn}: K4 missing or a library GEMM / "
             f"top-k kernel {library}")
    if not any(is_hand(n) and "srp_signs" in n for n in project) \
            or len(int64) > 2:
        fail(f"4e: the project stage ran {project}: K5 missing or an int64 "
             f"elementwise chain {int64}")


def check_feature_flags(fasta: str, out_dir: str, sim, card: str,
                        dev) -> None:
    """Phase 4e: run_pipeline on the main path with --profile --mprof
    --save-feature-matrix and the counts reset just before, checked as
    phase 4's launches and loads: trace/trace.json, mprof.dat and
    feature_matrix.npz must exist, the .npz embeddings and names must
    equal the result's, and the stages' kernels as check_stage_kernels
    says; logs the device busy time and idle share that the trace
    gives."""
    import numpy as np
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args

    config = config_from_args(["-i", fasta, "-o", out_dir, *FLAGS,
                               "--profile", "--mprof",
                               "--save-feature-matrix"])
    paths = stage_paths(sim, FLAGS, dev)
    reset_counts()
    t0 = time.perf_counter()
    with no_plain_on_card():
        res = pipeline.run_pipeline(config, dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check_launches(read_counts(COUNTERS), paths, "membership_embed",
                   "the 4e run")
    check_host(read_counts(HOST_COUNTERS), "parse", "the 4e run")
    trace = os.path.join(out_dir, "trace", "trace.json")
    mprof = os.path.join(out_dir, "mprof.dat")
    matrix = os.path.join(out_dir, "feature_matrix.npz")
    missing = [p for p in (trace, mprof, matrix) if not os.path.exists(p)]
    if missing:
        fail(f"4e: no {missing}")
    saved = np.load(matrix)
    if not (np.array_equal(saved["embeddings"], res.embeddings.cpu().numpy())
            and saved["names"].tolist() == res.names):
        fail("4e: feature_matrix.npz differs from the run's embeddings")
    with open(mprof) as f:
        lines = f.read().splitlines()
    if lines[0] != "MT 1.0" or not any(ln.startswith("MEM ")
                                       for ln in lines):
        fail(f"4e: mprof.dat is not in mprof format: {lines[:3]}")
    busy_us, n = device_busy_us(trace)
    if n == 0:
        fail("4e: the trace holds no device activity")
    check_stage_kernels(trace, card)
    log(f"4e --profile --mprof --save-feature-matrix: {wall_ms:.1f} ms of "
        f"wall (profiled); device busy {busy_us / 1e3:.3f} ms over {n} "
        f"kernels and copies: idle {100 * (1 - busy_us / 1e3 / wall_ms):.2f}"
        f"%; stage seconds " + ", ".join(
            f"{s} {res.metrics[s]['seconds']:.3f}" for s in STAGES)
        + f"; {len(lines) - 1} memory samples; feature_matrix.npz "
        f"{os.path.getsize(matrix)} bytes [{card}]")


def ultra_long_reads(sim):
    """Phase 5d's reads: `sim` plus ULTRA_READS error-free slices of its
    genome of ULTRA_MIN to ULTRA_MAX bases, every other one reverse
    complemented, as one SimulatedReads (so truth_overlaps covers them)."""
    import numpy as np

    from fedrann_tpu_torch.sim import SimulatedReads, _revcomp

    rng = np.random.default_rng(SIM_SEED + 5)
    names, seqs = list(sim.names), list(sim.sequences)
    starts, ends, strands = (list(sim.starts), list(sim.ends),
                             list(sim.strands))
    for i in range(ULTRA_READS):
        length = int(rng.integers(ULTRA_MIN, ULTRA_MAX + 1))
        start = int(rng.integers(0, len(sim.genome) - length))
        seq = sim.genome[start : start + length]
        names.append(f"ultra_{i}")
        seqs.append(_revcomp(seq) if i % 2 else seq)
        starts.append(start)
        ends.append(start + length)
        strands.append(i % 2)
    return SimulatedReads(names, seqs, np.asarray(starts, np.int64),
                          np.asarray(ends, np.int64),
                          np.asarray(strands, np.int8), sim.genome)


def check_split_reads(sim, out_dir: str, dev, card: str) -> dict:
    """Phase 5d: the long reads plus ultra-long reads, which the auto
    ladder (capped at 262,144 bases) splits. First, on the card, the
    merged union of the split reads (split_union_rows, then kernel C)
    against the plain union (per-segment read_hits_staged, unique,
    embed_hits_paired_signs) at phase 3's tolerance. Then run_pipeline
    with phase 4's flags and the counts reset just before: kernel C
    launched once per staging chunk and once per union group, every
    ultra-long read's fwd and rev rows nonzero, and the truth recall of
    pairs involving an ultra-long read that overlap >= LONG_MIN_OVERLAP.
    Returns the launch counts."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.kmers.library import build_library
    from fedrann_tpu_torch.project.embed import membership_embed
    from fedrann_tpu_torch.project.srp import build_precompute_signs
    from fedrann_tpu_torch.sim import write_fasta

    reads = ultra_long_reads(sim)
    fasta = os.path.join(out_dir, "ultra.fasta")
    os.makedirs(out_dir, exist_ok=True)
    write_fasta(fasta, reads.names, reads.sequences)
    config = config_from_args(["-i", fasta, "-o", os.path.join(out_dir, "o"),
                               *FLAGS])
    # no cache here: the run below parses
    packed = pipeline.load_reads(dataclasses.replace(config,
                                                     pack_cache=False))
    ultra = list(range(len(sim.names), len(reads.names)))
    if packed.split_read_ids is None or sorted(
            packed.split_read_ids.tolist()) != ultra:
        fail(f"5d: split reads {packed.split_read_ids}, want {ultra}")
    staged = pipeline.stage_reads(packed, config, dev)
    library = build_library([b.staged for b in staged],
                            config.kmer_min_multiplicity,
                            config.kmer_sample_fraction, config.seed)
    proj = build_precompute_signs(library.counts, config.embedding_dimension,
                                  config.projection_seed,
                                  config.projection_density)
    split = torch.tensor(ultra, dtype=torch.int64, device=dev)
    rows = pipeline.split_union_rows(staged, split)
    out = torch.zeros((2 * len(reads.names), config.embedding_dimension),
                      device=dev)
    before = membership_embed.launches
    n_hits = membership_embed(rows, library.codes, *proj,
                              torch.stack([2 * split, 2 * split + 1], dim=1),
                              out)
    torch.cuda.synchronize()
    if membership_embed.launches != before + 1:
        fail("5d: kernel C did not launch on the merged rows")
    fwd, rev = pipeline._split_union_plain(staged, split, library.codes,
                                           proj, config.embedding_dimension)
    atol = 1e-6 * float(proj[1].abs().max()) * max(int(n_hits.max()), 1)
    err = max(float((out[2 * split] - fwd).abs().max()),
              float((out[2 * split + 1] - rev).abs().max()))
    if not (torch.allclose(out[2 * split], fwd, rtol=1e-5, atol=atol)
            and torch.allclose(out[2 * split + 1], rev, rtol=1e-5,
                               atol=atol)):
        fail(f"5d: the merged union differs from the plain union: max abs "
             f"error {err} (atol {atol})")
    log(f"5d union: {len(ultra)} split reads of "
        f"{[len(reads.sequences[i]) for i in ultra]} bases, merged rows "
        f"{tuple(rows.shape)}, hits {n_hits.tolist()}; against the plain "
        f"union max abs error {err} (atol {atol})")
    chunks = sum(-(-b.staged.shape[0] // b.rows) for b in staged)
    groups = len(pipeline.split_union_groups(staged, split,
                                             config.window_batch))
    del staged, rows, proj, out

    paths = stage_paths(reads, FLAGS, dev)
    reset_counts()
    t0 = time.perf_counter()
    with no_plain_on_card():
        res = pipeline.run_pipeline(config, dev)
    wall = time.perf_counter() - t0
    launches = read_counts(COUNTERS)
    check_host(read_counts(HOST_COUNTERS), "parse", "the split-read run")
    check_launches(launches, paths, "membership_embed", "the split-read run")
    if launches["membership_embed"] != chunks + groups:
        fail(f"5d: kernel C launched {launches['membership_embed']} times, "
             f"want {chunks} staging chunks + {groups} union groups")
    norms = res.embeddings[[r for i in ultra for r in (2 * i, 2 * i + 1)]
                           ].norm(dim=1)
    if not (torch.isfinite(res.embeddings).all() and bool((norms > 0).all())):
        fail(f"5d: an ultra-long read embeds as zero: {norms.tolist()}")
    nbrs: dict[int, set] = {}
    for row, targets in enumerate(res.neighbor_indices):
        nbrs.setdefault(row // 2, set()).update(int(t) // 2 for t in targets)
    truth = [(a, b) for a, b in reads.truth_overlaps(LONG_MIN_OVERLAP)
             if a in ultra or b in ultra]
    found = sum(1 for a, b in truth if b in nbrs[a] or a in nbrs[b])
    recall = found / max(len(truth), 1)
    log(f"5d run: {len(reads.names)} reads ({len(ultra)} split) in "
        f"{wall:.2f} s; launches {launches} ({chunks} staging chunks, "
        f"{groups} union groups of at most {config.window_batch} slots); "
        f"stage seconds "
        + ", ".join(f"{s} {res.metrics[s]['seconds']:.3f}" for s in STAGES)
        + f"; recall of pairs with an ultra-long read overlapping >= "
        f"{LONG_MIN_OVERLAP}: {recall:.4f} over {len(truth)} pairs [{card}]")
    if not truth or recall < MIN_RECALL:
        fail(f"5d: truth recall {recall:.4f} below {MIN_RECALL}")
    return launches


def check_golden(out_dir: str, dev, card: str) -> int:
    """Phase 7: run_pipeline on each golden dataset with
    tests/test_golden_parity.py's flags and the counts reset just before:
    recall@20 >= 0.99, distance MAE < 5e-3 and query coverage 1.0 against
    the reference's overlaps_ref.tsv (the port's eval.py), min cosine >
    0.999 against ref_embeddings.npy matched by name and strand, the dense
    form and the fused staging kernel (keep_all) launched. Returns the
    dense form's launches."""
    import numpy as np
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.eval import OverlapTable, neighbor_recall
    from fedrann_tpu_torch.io.fastx import read_fastx
    from fedrann_tpu_torch.io.packing import pack_reads

    dense = 0
    for name in GOLDEN:
        data = os.path.join(HERE, "bench", "golden", name)
        config = golden_config(name, os.path.join(out_dir, name))
        paths = stage_kernels(pack_reads(
            read_fastx(config.input_path), config.length_buckets,
            split_overlap=config.kmer_size - 1), config, dev)
        reset_counts()
        t0 = time.perf_counter()
        with no_plain_on_card():
            res = pipeline.run_pipeline(config, dev)
        wall = time.perf_counter() - t0
        launches = read_counts(COUNTERS)
        host = read_counts(HOST_COUNTERS)
        check_launches(launches, paths, "membership_embed_dense",
                       f"the golden {name} run")
        # the imported library is read by the Python reader; the reads not
        if host["pack_reads_native"] != 1 or host["pack_reads"] != 0:
            fail(f"golden {name}: host counts {host}")
        dense += launches["membership_embed_dense"]
        rep = neighbor_recall(
            OverlapTable.read(os.path.join(data, "overlaps_ref.tsv")),
            OverlapTable.read(res.overlaps_path), k=20)
        ref = np.load(os.path.join(data, "ref_embeddings.npy"))
        with open(os.path.join(data, "ref_row_names.txt")) as f:
            ref_names = [ln.rstrip("\n") for ln in f]
        ref_row = {(ref_names[i], i % 2): i for i in range(len(ref_names))}
        ours = res.embeddings.cpu().numpy()
        sims = []
        for r, read in enumerate(res.names):
            for strand in (0, 1):
                a, b = ours[2 * r + strand], ref[ref_row[(read, strand)]]
                na, nb = np.linalg.norm(a), np.linalg.norm(b)
                if na == 0 or nb == 0:
                    if not na == nb == 0:
                        fail(f"golden {name}: {read} strand {strand} is "
                             "zero on one side only")
                    continue
                sims.append(float(a @ b / (na * nb)))
        log(f"golden {name} (k={config.kmer_size}): {rep}; min cosine "
            f"{min(sims):.7f} over {len(sims)} rows; {wall:.2f} s; launches "
            f"{launches}; stage seconds " + ", ".join(
                f"{s} {res.metrics[s]['seconds']:.3f}" for s in STAGES)
            + f" [{card}]")
        if not (rep.query_coverage == 1.0
                and rep.recall_at_k >= GOLDEN_RECALL
                and rep.distance_mae < GOLDEN_MAE
                and min(sims) > GOLDEN_COSINE
                and torch.isfinite(res.embeddings).all()):
            fail(f"golden {name}: {rep}, min cosine {min(sims)}")
    return dense


def profile_cli(fasta: str, out_dir: str, card: str, label: str) -> None:
    """--profile: two more CLI runs on `fasta`, the second under
    torch.profiler. Prints each run's wall and stage seconds; then, for the
    profiled run, the device's busy time (the union of the time intervals
    of its kernels and copies), its idle share of the run's wall time, and
    the device time, summed over launches, of the 20 largest kernels or
    copies and of every hand kernel."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedrann_tpu_torch.cli import main as cli_main

    for run, profiled in (("warm", False), ("profiled", True)):
        out = os.path.join(out_dir, run)
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            rc = cli_main(["-i", fasta, "-o", out, *FLAGS])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if rc != 0:
            fail(f"profile {label}: cli.main returned {rc}")
        with open(os.path.join(out, "metrics.json")) as f:
            stages = json.load(f)
        log(f"profile {label} {run} run: wall {wall_ms:.1f} ms; "
            + ", ".join(f"{s} {stages[s]['seconds']:.3f}" for s in STAGES)
            + f" s [{card}]")
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        fail(f"profile {label}: torch.profiler recorded no device activity")
    busy_us, cur = 0.0, None
    per_name: dict[str, list] = {}
    for start, end, name in spans:
        if cur is None or start > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
        acc = per_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += end - start
    busy_us += cur[1] - cur[0]
    summed_us = sum(us for _, us in per_name.values())
    log(f"profile {label}: device busy {busy_us / 1e3:.3f} ms (union of "
        f"device intervals), device time summed over launches "
        f"{summed_us / 1e3:.3f} ms, in {wall_ms:.1f} ms of wall: idle "
        f"{100 * (1 - busy_us / 1e3 / wall_ms):.2f}% [{card}]")
    # the 20 largest, and every hand kernel (csrc/*.cu, anonymous namespace)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    for rank, (name, (n, us)) in enumerate(ranked):
        if rank < 20 or is_hand(name):
            log(f"  {us / 1e3:9.3f} ms {n:5d} x {name[:100]}")


def overlap_sets(path: str) -> dict:
    """(query, orientation) -> its set of (target, orientation) rows in an
    overlaps.tsv."""
    rows: dict = {}
    with open(path) as f:
        f.readline()
        for line in f:
            q, qo, t, to, _rank, _dist = line.rstrip("\n").split("\t")
            rows.setdefault((q, qo), set()).add((t, to))
    return rows


def table_agreement(path: str, theirs: dict) -> float:
    """Mean over the queries of `theirs` (overlap_sets of a reference
    table) of the share of their neighbors the overlaps.tsv at `path`
    lists too."""
    ours = overlap_sets(path)
    return sum(len(ours.get(key, set()) & want) / max(len(want), 1)
               for key, want in theirs.items()) / len(theirs)


def check_ooc_cli(fasta: str, out_dir: str, in_core_tsv: str, sim,
                  card: str, dev) -> dict:
    """Phase 8a: the CLI main path on phase 4's reads past
    --knn-hbm-budget OOC_CLI_BUDGET, checked as phase 4 (drive_cli) and
    more: the valve trips, the search runs the port's plan (>= 2 query
    slabs, >= 4 candidate blocks) and never knn_exact, kernel C launches
    once per staging chunk, and the embed stage's peak device memory
    (torch.cuda.max_memory_allocated over what was allocated before it)
    stays below the (2R, d) float32 matrix; neighbor agreement >=
    OOC_AGREE_CLI with phase 4's in-core overlaps.tsv. Returns the launch
    counts."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.io.native import pack_reads_native
    from fedrann_tpu_torch.knn.ooc import plan_bytes, plan_ooc
    from fedrann_tpu_torch.knn.topk import sm_count

    flags = [*FLAGS, "--knn-hbm-budget", OOC_CLI_BUDGET]
    config = config_from_args(["-i", fasta, "-o", out_dir, *flags])
    n_reads, d, k = (len(sim.names), config.embedding_dimension,
                     config.n_neighbors)
    n = 2 * n_reads
    sms = sm_count(dev)
    q_rows, c_rows, ct = plan_ooc(n, d, k, config.knn_hbm_budget,
                                  config.knn_query_tile, sms=sms)
    slabs, blocks = -(-n // q_rows), -(-n // c_rows)
    log(f"8a plan at --knn-hbm-budget {OOC_CLI_BUDGET} "
        f"({config.knn_hbm_budget} bytes), {n} x {d} rows, k = {k}: "
        f"{slabs} query slabs x {q_rows} rows, {blocks} candidate blocks x "
        f"{c_rows} rows, candidate tile {ct}; the plan holds "
        f"{plan_bytes(q_rows, c_rows, ct, config.knn_query_tile, d, k, 2, sms)} "
        f"bytes ({sms} SMs)")
    if not pipeline.out_of_core(config, n_reads) or slabs < 2 or blocks < 4:
        fail(f"8a: budget {OOC_CLI_BUDGET} gives {slabs} slabs and {blocks} "
             "blocks out of core, want >= 2 and >= 4")
    packed = pack_reads_native(fasta, config.length_buckets,
                               split_overlap=config.kmer_size - 1)
    chunks = sum(-(-b.read_index.shape[0] // pipeline.chunk_rows(
        b.length, b.read_index.shape[0], config)) for b in packed.buckets)

    peak = {}
    embed, in_core = pipeline.compute_embeddings, pipeline.knn_exact

    def measured_embed(*args, **kwargs):
        torch.cuda.synchronize(dev)
        peak["before"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        emb = embed(*args, **kwargs)
        torch.cuda.synchronize(dev)
        peak["delta"] = torch.cuda.max_memory_allocated(dev) - peak["before"]
        return emb

    def no_in_core(*args, **kwargs):
        fail("8a: the out-of-core run called knn_exact")

    pipeline.compute_embeddings, pipeline.knn_exact = measured_embed, \
        no_in_core
    try:
        launches, secs = drive_cli(fasta, out_dir, sim, MIN_OVERLAP, card,
                                   dev, flags)
    finally:
        pipeline.compute_embeddings, pipeline.knn_exact = embed, in_core
    host = read_counts(HOST_COUNTERS)
    if (host["ooc_slabs"], host["ooc_blocks"]) != (slabs, slabs * blocks):
        fail(f"8a: {host['ooc_slabs']} slabs and {host['ooc_blocks']} "
             f"blocks uploaded, the plan says {slabs} x {blocks}")
    if launches["membership_embed"] != chunks:
        fail(f"8a: kernel C launched {launches['membership_embed']} times, "
             f"want one per staging chunk ({chunks})")
    matrix = n * d * 4
    if "delta" not in peak or peak["delta"] >= matrix:
        fail(f"8a: embed held {peak.get('delta')} bytes of device memory "
             f"at its peak, not below the {matrix}-byte (2R, d) matrix")
    agree = table_agreement(os.path.join(out_dir, "overlaps.tsv"),
                            overlap_sets(in_core_tsv))
    log(f"8a out of core: {slabs} slabs x {blocks} blocks, H2D "
        f"{host['ooc_h2d_bytes']} bytes; kernel C {chunks} launches (one a "
        f"staging chunk); embed peak {peak['delta']} bytes over the "
        f"{peak['before']} allocated before it, against the {matrix}-byte "
        f"matrix; neighbor agreement with phase 4's in-core overlaps.tsv "
        f"{agree:.5f}; knn {secs['knn']:.3f} s, embed {secs['embed']:.3f} s "
        f"[{card}]")
    if agree < OOC_AGREE_CLI:
        fail(f"8a: agreement {agree:.5f} with the in-core run below "
             f"{OOC_AGREE_CLI}")
    return launches


def check_fp32_cli(fasta: str, out_dir: str, in_core_tsv: str, sim,
                   card: str, dev, secs4: dict) -> int:
    """Phase 4f: phase 4's reads and flags at --knn-precision fp32, checked
    as phase 4 (drive_cli: truth recall >= MIN_RECALL), K4's fp32 form
    launched once (one search over every row); its neighbor agreement with
    phase 4's table and knn seconds logged. Then again at
    --knn-hbm-budget OOC_CLI_BUDGET, out of core: the card's plan (float32
    wire rows) uploaded, one fp32 launch a slab and block, agreement >=
    OOC_AGREE_CLI with the in-core fp32 table. Returns the fp32 form's
    launches over both runs."""
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.knn.ooc import plan_ooc
    from fedrann_tpu_torch.knn.topk import sm_count

    flags = [*FLAGS, "--knn-precision", "fp32"]
    launches, secs = drive_cli(fasta, os.path.join(out_dir, "in_core"), sim,
                               MIN_OVERLAP, card, dev, flags)
    if (launches["knn_merge"], launches["knn_merge_fp32"]) != (1, 1):
        fail(f"4f: K4 launched {launches['knn_merge']} times, its fp32 form "
             f"{launches['knn_merge_fp32']}, want one fp32 search")
    tsv = os.path.join(out_dir, "in_core", "overlaps.tsv")
    agree = table_agreement(tsv, overlap_sets(in_core_tsv))
    log(f"4f --knn-precision fp32: knn {secs['knn']:.3f} s (phase 4, bf16: "
        f"{secs4['knn']:.3f} s); neighbor agreement with phase 4's table "
        f"{agree:.5f} [{card}]")
    total = launches["knn_merge_fp32"]

    flags = [*flags, "--knn-hbm-budget", OOC_CLI_BUDGET]
    config = config_from_args(["-i", fasta, "-o", "-", *flags])
    n, d, k = 2 * len(sim.names), config.embedding_dimension, \
        config.n_neighbors
    q_rows, c_rows, _ = plan_ooc(n, d, k, config.knn_hbm_budget,
                                 config.knn_query_tile, itemsize=4,
                                 sms=sm_count(dev))
    slabs, blocks = -(-n // q_rows), -(-n // c_rows)
    launches, secs = drive_cli(fasta, os.path.join(out_dir, "ooc"), sim,
                               MIN_OVERLAP, card, dev, flags)
    host = read_counts(HOST_COUNTERS)
    if (host["ooc_slabs"], host["ooc_blocks"]) != (slabs, slabs * blocks) \
            or launches["knn_merge_fp32"] != slabs * blocks \
            or launches["knn_merge"] != slabs * blocks:
        fail(f"4f out of core: {host['ooc_slabs']} slabs and "
             f"{host['ooc_blocks']} blocks uploaded, K4 {launches['knn_merge']} "
             f"launches ({launches['knn_merge_fp32']} fp32); the plan says "
             f"{slabs} x {blocks}, one fp32 launch each")
    agree_ooc = table_agreement(os.path.join(out_dir, "ooc", "overlaps.tsv"),
                                overlap_sets(tsv))
    log(f"4f --knn-precision fp32 --knn-hbm-budget {OOC_CLI_BUDGET}: "
        f"{slabs} slabs x {blocks} blocks of float32 wire rows, "
        f"{launches['knn_merge_fp32']} fp32 merges, H2D "
        f"{host['ooc_h2d_bytes']} bytes; knn {secs['knn']:.3f} s; neighbor "
        f"agreement with the in-core fp32 table {agree_ooc:.5f} [{card}]")
    if agree_ooc < OOC_AGREE_CLI:
        fail(f"4f: out-of-core agreement {agree_ooc:.5f} with the in-core "
             f"fp32 run below {OOC_AGREE_CLI}")
    return total + launches["knn_merge_fp32"]


def merge_workspace(dev, q_rows: int, c_rows: int, d: int,
                    k: int) -> tuple[int, str]:
    """One merge_block at the plan's slab x block shape (q_rows x c_rows x
    d, k neighbors, into a carry), on the card: the device bytes it holds
    past what the card's plan counts for it (K4's split scratch, 8 bytes a
    query row, neighbor and unit where it splits; 0 when the count covers
    them), and a log of its units, event time and bytes."""
    import torch

    from fedrann_tpu_torch.knn.topk import k4_units, merge_block, sm_count

    q = torch.randn((q_rows, d), device=dev).to(torch.bfloat16)
    c = torch.randn((c_rows, d), device=dev).to(torch.bfloat16)
    run = merge_block(None, q, c, 0, k)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    merge_block(run, q, c, c_rows, k)
    torch.cuda.synchronize(dev)
    used = torch.cuda.max_memory_allocated(dev) - before
    units = k4_units(q_rows, c_rows, k, sm_count(dev))
    counted = units * q_rows * k * 8 if units > 1 else 0
    ms = time_cuda(lambda: merge_block(run, q, c, c_rows, k), 3)
    ops = 2 * q_rows * c_rows * d
    text = (f"one merge at the plan's slab x block, {q_rows} x {c_rows} x "
            f"{d}, k = {k}: {merge_block.last_units} units (planned "
            f"{units}), {ms:.3f} ms = {ops / ms / 1e9:.1f} TFLOP/s, "
            f"{used} bytes held past the rows and carry (plan counts "
            f"{counted})")
    del q, c, run
    return max(0, used - counted), text


def rank16_rows(n: int, d: int):
    """(n, d) float32 rows of rank 16 plus noise (tests/test_knn_ooc.py's
    structure) made by numpy from FLAGS' --seed, and the generator."""
    import numpy as np

    rng = np.random.default_rng(int(FLAGS[FLAGS.index("--seed") + 1]))
    emb = (rng.standard_normal((n, 16), dtype=np.float32)
           @ rng.standard_normal((16, d), dtype=np.float32))
    emb += np.float32(0.25) * rng.standard_normal((n, d), dtype=np.float32)
    return emb, rng


def check_ooc_search(dev, card: str) -> float:
    """Phase 8b: knn_exact_ooc on OOC_ROWS x 512 rows of rank 16 plus noise
    (tests/test_knn_ooc.py's structure) made by numpy from FLAGS' --seed,
    k = 50, at OOC_BUDGET bytes: the slabs and blocks the port's plan says,
    peak device memory over the call within the budget plus what one
    merge at the plan's slab x block holds past the card's plan
    (merge_workspace, which logs that merge), and on OOC_SAMPLE query rows
    agreement >= OOC_AGREE_SEARCH with an in-core top-k over the same wire
    rows (K4 in one launch on the card: every distance the same, bitwise),
    and against merge_block_plain's top-k over them at K4's bars
    (hold_k4). Logs the search's seconds, its H2D bytes and rate,
    host_wire's seconds, one block's copy alone, one merge's event and
    device time (K4's and the plain version's) at 512 query rows and the
    plan's tile and knn_exact's, and knn_exact's seconds on the same rows.
    Returns the search's seconds."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn import ooc
    from fedrann_tpu_torch.knn.topk import (
        keys_to_host,
        knn_exact,
        merge_block,
        merge_block_plain,
        sm_count,
    )

    n, d, k, budget = OOC_ROWS, 512, 50, OOC_BUDGET
    t0 = time.perf_counter()
    emb, rng = rank16_rows(n, d)
    made = time.perf_counter() - t0
    sms = sm_count(dev)
    q_rows, c_rows, ct = ooc.plan_ooc(n, d, k, budget, sms=sms)
    slabs, blocks = -(-n // q_rows), -(-n // c_rows)
    held = ooc.plan_bytes(q_rows, c_rows, ct, 512, d, k, 2, sms)
    cpu_slabs = -(-n // ooc.plan_ooc(n, d, k, budget)[0])
    workspace, one_merge = merge_workspace(dev, q_rows, c_rows, d, k)
    log(f"8b plan on the card ({sms} SMs): {n} x {d} rows (made in "
        f"{made:.2f} s), k = {k}, budget {budget} bytes: {slabs} query slabs "
        f"x {q_rows} rows ({cpu_slabs} on the CPU's plan), {blocks} "
        f"candidate blocks x {c_rows} rows; the plan holds {held} bytes; "
        f"{one_merge}; workspace past the plan's count {workspace} bytes "
        f"[{card}]")

    fn = ooc.knn_exact_ooc
    fn.slabs = fn.blocks_uploaded = fn.h2d_bytes = 0
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    idx, dist = ooc.knn_exact_ooc(emb, k, budget, transfer="f32", device=dev)
    secs = time.perf_counter() - t0
    delta = torch.cuda.max_memory_allocated(dev) - before
    if (fn.slabs, fn.blocks_uploaded) != (slabs, slabs * blocks):
        fail(f"8b: {fn.slabs} slabs and {fn.blocks_uploaded} blocks "
             f"uploaded, the plan says {slabs} x {blocks}")
    if held > budget or delta > budget + workspace:
        fail(f"8b: the search held {delta} bytes at its peak (plan "
             f"{held}), past the {budget}-byte budget + {workspace}")

    t0 = time.perf_counter()
    wire = ooc.host_wire(emb)  # the search's own first step, timed alone
    wire_secs = time.perf_counter() - t0
    sample = np.sort(rng.choice(n, OOC_SAMPLE, replace=False))
    cand = wire.to(dev)
    q = cand[torch.from_numpy(sample).to(dev)]
    keys = merge_block(None, q, cand, 0, k)
    ref_idx, ref_dist = keys_to_host(keys, "f32", n)
    agree = np.mean([len(set(a) & set(b)) / k
                     for a, b in zip(idx[sample], ref_idx)])
    err = float(np.abs(np.sort(dist[sample], 1) - np.sort(ref_dist, 1)).max())
    plain_err, plain_agree, ties, _ = hold_k4("8b", keys, q, cand, k,
                                              "bf16")
    del cand, q, keys

    # one merge of 512 query rows over 8a's tile, the plan's and
    # knn_exact's: event time (what a merge costs the stream, launch gaps
    # included) beside device time, K4 and its plain version
    costs = []
    for width in sorted({512, ct, 131072}):
        q = torch.randn((512, d), device=dev).to(torch.bfloat16)
        c = torch.randn((width, d), device=dev).to(torch.bfloat16)
        run = merge_block(None, q, c, 0, k)

        def merge(run=run, q=q, c=c, width=width):
            merge_block(run, q, c, width, k)

        def plain(run=run, q=q, c=c, width=width):
            merge_block_plain(run, q, c, width, k)

        costs.append(
            f"{width}-row tile K4 {time_cuda(merge, 20) * 1e3:.1f} us by "
            f"events, device {device_us(merge, 20, True)} us; plain "
            f"{time_cuda(plain, 5) * 1e3:.1f} us")
    del q, c, run
    log(f"8b one merge of 512 query rows: {'; '.join(costs)} [{card}]")

    block = torch.empty((c_rows, d), dtype=torch.bfloat16, pin_memory=True)
    on_card = torch.empty((c_rows, d), dtype=torch.bfloat16, device=dev)
    copy_ms = time_cuda(lambda: on_card.copy_(block, non_blocking=True), 5)
    del block, on_card
    rows = torch.from_numpy(emb).to(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    knn_exact(rows, k, transfer="f32")
    exact = time.perf_counter() - t0
    del rows
    log(f"8b search: {secs:.3f} s out of core against knn_exact {exact:.3f} "
        f"s on the same rows ({secs / exact:.3f}x), of which host_wire (the "
        f"host normalize and round) {wire_secs:.3f} s; H2D {fn.h2d_bytes} "
        f"bytes = {fn.h2d_bytes / secs / 1e9:.2f} GB/s over the search, one "
        f"{c_rows}-row block alone {copy_ms:.3f} ms = "
        f"{c_rows * d * 2 / copy_ms / 1e6:.2f} GB/s; peak {delta} bytes over "
        f"the call (plan {held}, budget {budget}); on {OOC_SAMPLE} sampled "
        f"queries agreement {agree:.5f} with the in-core top-k (K4), sorted "
        f"distances within {err:.3g}; against merge_block_plain agreement "
        f"{plain_agree:.5f}, scores within {plain_err:.3g}, {ties} near-tie "
        f"rows; page-locked by torch's host cache: {pinned_bytes()} "
        f"[{card}]")
    if agree < OOC_AGREE_SEARCH or err > 1e-6:
        fail(f"8b: agreement {agree:.5f} (want >= {OOC_AGREE_SEARCH}), "
             f"distance error {err} (want <= 1e-6)")
    return secs


def sharded_mesh(strategy: str, devices: list):
    """The mesh of a phase 9 search: ring2d on (2, n/2) where the entries
    split in two, else one axis."""
    from fedrann_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    if strategy == "ring2d":
        return make_mesh_2d(2 if len(devices) % 2 == 0 else 1, devices)
    return make_mesh(devices=devices)


def set_agreement(idx, want) -> float:
    """Mean over rows of |idx[r] & want[r]| / k, for rows of distinct
    indices: the duplicates of each sorted concatenated row."""
    import numpy as np

    both = np.sort(np.concatenate([idx, want], axis=1), axis=1)
    return float((both[:, 1:] == both[:, :-1]).sum() / want.size)


def measured(fn, devices: list):
    """(fn(), host seconds, peak device bytes past what was allocated
    before, the most over `devices`) of one call that ends on the host."""
    import torch

    cards = sorted(set(devices), key=str)
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    before = {d: torch.cuda.memory_allocated(d) for d in cards}
    t0 = time.perf_counter()
    out = fn()
    secs = time.perf_counter() - t0
    return out, secs, max(torch.cuda.max_memory_allocated(d) - before[d]
                          for d in cards)


def check_sharded_search(devices: list, card: str, label: str) -> None:
    """Phase 9a (and 9d on the real cards): knn_exact_sharded with each
    strategy over the mesh `devices` on SHARD_ROWS x 512 rows of rank 16
    plus noise from FLAGS' --seed, k = SHARD_K, against knn_exact on the
    same rows: index agreement >= SHARD_AGREE_SEARCH and distances within
    1e-5. Each call runs twice, the first (cold: the first at these shapes
    on these cards in this process) and the second (warm) timed apart;
    logs the warm call's seconds beside knn_exact's, the cold call's, its
    peak device memory and its merges."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn.ring import knn_exact_sharded
    from fedrann_tpu_torch.knn.topk import knn_exact

    rows = torch.from_numpy(rank16_rows(SHARD_ROWS, 512)[0]).to(devices[0])
    _, exact_cold, _ = measured(
        lambda: knn_exact(rows, SHARD_K, transfer="f32"), devices)
    (want_i, want_d), exact_secs, exact_peak = measured(
        lambda: knn_exact(rows, SHARD_K, transfer="f32"), devices)
    for strategy in SHARD_STRATEGIES:
        mesh = sharded_mesh(strategy, devices)

        def search(mesh=mesh, strategy=strategy):
            return knn_exact_sharded(rows, SHARD_K, mesh=mesh,
                                     strategy=strategy, transfer="f32")

        _, cold, _ = measured(search, devices)
        merges = knn_exact_sharded.merges
        (idx, dist), secs, peak = measured(search, devices)
        agree = set_agreement(idx, want_i)
        err = float(np.abs(dist - want_d).max())
        log(f"9a {strategy} over a {mesh.shape} mesh of {label}, "
            f"{SHARD_ROWS} x 512 rows, k = {SHARD_K}: {secs:.3f} s warm "
            f"against knn_exact {exact_secs:.3f} s ({secs / exact_secs:.3f}x; "
            f"cold {cold:.3f} s against {exact_cold:.3f} s); peak {peak} "
            f"bytes (knn_exact {exact_peak}); "
            f"{knn_exact_sharded.merges - merges} merges; agreement "
            f"{agree:.6f}, distances within {err:.3g} [{card}]")
        if agree < SHARD_AGREE_SEARCH or err > 1e-5 or idx.min() < 0 \
                or idx.max() >= SHARD_ROWS:
            fail(f"9a {strategy} on {label}: agreement {agree:.6f} (want >= "
                 f"{SHARD_AGREE_SEARCH}), distance error {err} (want <= "
                 f"1e-5), indices in [{idx.min()}, {idx.max()}]")


def check_sharded_cli(fasta: str, out_dir: str, in_core_tsv: str, sim,
                      card: str, dev, phase4: tuple) -> dict:
    """Phase 9b: phase 4's reads through the CLI with --knn-sharded always,
    once per strategy, checked as phase 4 (drive_cli), and more:
    knn_exact_sharded called once over device_count() cards, the staging
    kernels and kernel C launched as in phase 4, neighbor agreement >=
    SHARD_AGREE_CLI with phase 4's overlaps.tsv (and whether it is
    byte-identical); knn seconds logged beside phase 4's. Returns the
    launch counts of the three runs summed."""
    import torch

    from fedrann_tpu_torch.knn.ring import knn_exact_sharded

    launches4, secs4 = phase4
    cards = torch.cuda.device_count()
    theirs = overlap_sets(in_core_tsv)
    with open(in_core_tsv, "rb") as f:
        in_core = f.read()
    totals: dict = {}
    for strategy in SHARD_STRATEGIES:
        out = os.path.join(out_dir, strategy)
        launches, secs = drive_cli(
            fasta, out, sim, MIN_OVERLAP, card, dev,
            [*FLAGS, "--knn-sharded", "always", "--knn-shard-strategy",
             strategy])
        calls = read_counts(HOST_COUNTERS)["sharded_knn_calls"]
        if (calls, knn_exact_sharded.devices) != (1, cards):
            fail(f"9b {strategy}: knn_exact_sharded called {calls} times "
                 f"over {knn_exact_sharded.devices} devices, want once over "
                 f"{cards}")
        moved = {name: (launches[name], launches4[name])
                 for name in (*STAGE_KERNELS, *EMBED_KERNELS)
                 if launches[name] != launches4[name]}
        if moved:
            fail(f"9b {strategy}: launches (this run, phase 4) {moved}")
        path = os.path.join(out, "overlaps.tsv")
        agree = table_agreement(path, theirs)
        with open(path, "rb") as f:
            same = f.read() == in_core
        log(f"9b --knn-sharded always --knn-shard-strategy {strategy}: "
            f"{cards} card(s); knn {secs['knn']:.3f} s against phase 4's "
            f"{secs4['knn']:.3f} s; neighbor agreement with phase 4's "
            f"overlaps.tsv {agree:.5f}, "
            f"{'byte-identical' if same else 'not byte-identical'} [{card}]")
        if agree < SHARD_AGREE_CLI:
            fail(f"9b {strategy}: agreement {agree:.5f} with phase 4 below "
                 f"{SHARD_AGREE_CLI}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
    return totals


def step_inputs(fasta: str, dev):
    """Phase 4's configuration, its reads' first bucket on `dev` in the
    2-bit form the pipeline uploads, the bucket's real read count (its
    rows' prefix), and the library and float32 paired table a run on
    them builds."""
    import torch

    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.io.native import pack_reads_native
    from fedrann_tpu_torch.kmers.library import build_library
    from fedrann_tpu_torch.project.srp import build_precompute_paired

    config = config_from_args(["-i", fasta, "-o", "-", *FLAGS])
    packed = pack_reads_native(fasta, config.length_buckets,
                               split_overlap=config.kmer_size - 1)
    library = build_library(
        [b.staged for b in pipeline.stage_reads(packed, config, dev)],
        config.kmer_min_multiplicity, config.kmer_sample_fraction,
        config.seed)
    p_pair = build_precompute_paired(
        library.counts, config.embedding_dimension, config.projection_seed,
        config.projection_density, dtype=torch.float32)
    bucket = packed.buckets[0]
    n_real = int((bucket.read_index >= 0).sum())
    if not (bucket.read_index[:n_real] >= 0).all():
        fail("9c: the first bucket's real reads are not a prefix of its rows")
    return (config, pipeline.upload_bucket(bucket, dev), n_real, library,
            p_pair)


def check_sharded_step(inputs, devices: list, card: str, label: str) -> dict:
    """Phase 9c (and 9d on the real cards): the sharded step on phase 4's
    first bucket over the mesh `devices`: the fused staging kernel and
    kernel C's dense form launch once per mesh entry, and the neighbor
    lists agree >= SHARD_AGREE_STEP with the one-device composition
    (stage_candidates, membership_embed_dense, knn_exact). Returns the
    step's launches by kernel name."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.kmers.membership import stage_candidates
    from fedrann_tpu_torch.knn.topk import knn_exact
    from fedrann_tpu_torch.parallel.mesh import make_mesh
    from fedrann_tpu_torch.parallel.step import (
        make_sharded_step,
        shard_step_inputs,
        staging_args,
    )
    from fedrann_tpu_torch.project.embed import membership_embed_dense

    config, bases, n_real, library, p_pair = inputs
    k, seed, frac = (config.kmer_size, config.seed,
                     config.kmer_sample_fraction)
    mesh = make_mesh(devices=devices)
    step = make_sharded_step(mesh, k, None, config.n_neighbors,
                             precision=config.knn_precision,
                             sampling=(seed, frac), n_reads=n_real)
    args = shard_step_inputs(mesh, bases, library.codes, p_pair)
    fused = f"{bases.source}_launches"
    before = (getattr(stage_candidates, fused),
              membership_embed_dense.launches)
    (dist, idx), secs, peak = measured(lambda: step(*args), devices)
    runs = (getattr(stage_candidates, fused) - before[0],
            membership_embed_dense.launches - before[1])
    if runs != (mesh.size, mesh.size):
        fail(f"9c on {label}: fk_stage_rows ({bases.source}) and "
             f"fk_membership_embed_dense launched {runs} times, want once "
             f"per mesh entry ({mesh.size})")
    rows = bases.shape[0]
    staged, _ = stage_candidates(bases, k, *staging_args(
        bases.shape[1] - k + 1, None, (seed, frac)))
    emb = torch.zeros((2 * rows, p_pair.shape[1] // 2), device=bases.device)
    membership_embed_dense(staged, library.codes, p_pair, torch.arange(
        2 * rows, device=bases.device).view(rows, 2), emb)
    want_i, want_d = knn_exact(emb[: 2 * n_real], config.n_neighbors,
                               precision=config.knn_precision,
                               transfer="f32")
    agree = set_agreement(idx, want_i)
    err = float(np.abs(dist - want_d).max())
    log(f"9c sharded step on phase 4's first bucket ({rows} rows, {n_real} "
        f"reads, {bases.shape[1]} bases, {bases.source} source) over "
        f"{mesh.size} entries of {label}: fk_stage_rows {runs[0]} and "
        f"fk_membership_embed_dense {runs[1]} launches (one an entry); "
        f"{secs:.3f} s, peak {peak} bytes; agreement with the one-device "
        f"composition {agree:.6f}, distances within {err:.3g} [{card}]")
    if agree < SHARD_AGREE_STEP or idx.max() >= 2 * n_real:
        fail(f"9c on {label}: agreement {agree:.6f} (want >= "
             f"{SHARD_AGREE_STEP}), largest index {idx.max()}")
    return {f"stage_rows_{bases.source}": runs[0],
            "membership_embed_dense": runs[1]}


def check_last_card(inputs, last, card: str) -> None:
    """Phase 9d: with cuda:0 current, each hand kernel of the main path on
    tensors of the card `last`, against its plain version (computed on
    cuda:0): the fused kernel on the first 512 rows of phase 4's first
    bucket, kernel A and B's device-memory path on keep_all rows of
    KEEP_ALL_BUCKET bases, bitwise; kernel C's sign and dense forms on the
    fused kernel's rows at phase 3's tolerance."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.kmers.codec import (
        _canonical_sample_plain,
        as_bytes,
        canonical_sample,
    )
    from fedrann_tpu_torch.kmers.membership import (
        _select_candidates_plain,
        select_candidates,
        stage_candidates,
    )
    from fedrann_tpu_torch.parallel.mesh import to_device
    from fedrann_tpu_torch.parallel.step import staging_args
    from fedrann_tpu_torch.project.embed import (
        _membership_embed_dense_plain,
        _membership_embed_plain,
        membership_embed,
        membership_embed_dense,
    )
    from fedrann_tpu_torch.project.srp import build_precompute_signs

    config, bases, _, library, p_pair = inputs
    torch.cuda.set_device(0)
    k = config.kmer_size

    hb, keep_all, seed, thr, cap = staging_args(
        bases.shape[1] - k + 1, None, (config.seed,
                                       config.kmer_sample_fraction))
    chunk = bases[:512]
    want = _select_candidates_plain(_canonical_sample_plain(
        as_bytes(chunk), k, seed, thr, keep_all), hb, keep_all, cap)
    counts = (stage_candidates.launches, canonical_sample.launches,
              select_candidates.long_launches, membership_embed.launches,
              membership_embed_dense.launches)
    got = stage_candidates(to_device(chunk, last), k, hb, keep_all, seed,
                           thr, cap)
    rng = np.random.default_rng(SIM_SEED)
    long_rows = torch.from_numpy(rng.integers(
        0, 4, (6, KEEP_ALL_BUCKET)).astype(np.uint8)).to(bases.device)
    w = KEEP_ALL_BUCKET - k + 1
    long_want = _select_candidates_plain(_canonical_sample_plain(
        long_rows, k, seed, 0, True), w, True, None)
    long_got = stage_candidates(long_rows.to(last), k, w, True, seed, 0,
                                None)
    signs, mags = build_precompute_signs(
        library.counts, config.embedding_dimension, config.projection_seed,
        config.projection_density)
    r = want[0].shape[0]
    targets = torch.arange(2 * r, device=want[0].device).view(r, 2)
    outs = {}
    for name, fn, plain, table in (
            ("C sign", membership_embed, _membership_embed_plain,
             (signs, mags)),
            ("C dense", membership_embed_dense,
             _membership_embed_dense_plain, (p_pair,))):
        out = torch.zeros((2 * r, config.embedding_dimension), device=last)
        n = fn(got[0], library.codes.to(last), *(t.to(last) for t in table),
               targets.to(last), out)
        out_p = torch.zeros((2 * r, config.embedding_dimension),
                            device=want[0].device)
        n_p = plain(want[0], library.codes, *table, targets, out_p)
        outs[name] = (n, out, n_p, out_p, max(
            float(t.float().abs().max()) for t in table))
    torch.cuda.synchronize(last)
    runs = tuple(b - a for a, b in zip(counts, (
        stage_candidates.launches, canonical_sample.launches,
        select_candidates.long_launches, membership_embed.launches,
        membership_embed_dense.launches)))
    if runs != (1, 1, 1, 1, 1) or torch.cuda.current_device() != 0:
        fail(f"9d: launches (fused, A, B long, C sign, C dense) {runs}, "
             f"want one each; current device {torch.cuda.current_device()}")
    for what, (g, wnt) in (("fused", (got, want)),
                           ("A + B device memory", (long_got, long_want))):
        if not (torch.equal(g[0].cpu(), wnt[0].cpu())
                and torch.equal(g[1].cpu(), wnt[1].cpu())):
            fail(f"9d: {what} on {last} differs from its plain version")
    errs = []
    for name, (n, out, n_p, out_p, scale) in outs.items():
        err = float((out.cpu() - out_p.cpu()).abs().max())
        if not torch.equal(n.cpu(), n_p.cpu()) or not torch.allclose(
                out.cpu(), out_p.cpu(), rtol=1e-5,
                atol=1e-6 * scale * int(n_p.max())):
            fail(f"9d: kernel {name} on {last} differs from its plain "
                 f"version: max abs error {err}")
        errs.append(f"{name} max abs error {err:.3g}")
    log(f"9d on {last} with cuda:0 current: the fused kernel "
        f"({chunk.shape[0]} x {bases.shape[1]} {bases.source}), kernel A and B's device-memory "
        f"path (6 x {KEEP_ALL_BUCKET} keep_all) bitwise; "
        + ", ".join(errs) + f" [{card}]")


def check_other_cards(inputs, card: str) -> None:
    """Phase 9d: where more than one card is visible, 9a and 9c over
    every card, each hand kernel on the last card (check_last_card), and
    one 9a block's copy from cuda:0 to cuda:1; on one card, one line."""
    import torch

    from fedrann_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        log(f"9d: {n} card visible: the runs over real cards and the "
            "launches on another card need two or more; none run")
        return
    devices = list(make_mesh().devices)
    check_sharded_search(devices, card, f"{n} cards")
    check_sharded_step(inputs, devices, card, f"{n} cards")
    check_last_card(inputs, devices[-1], card)
    rows = SHARD_ROWS // len(devices)
    block = torch.randn((rows, 512), device=devices[0])
    ms = time_cuda(lambda: block.to(devices[1]), 20)
    log(f"9d peer copy: one {rows} x 512 float32 block cuda:0 -> cuda:1 in "
        f"{ms:.4f} ms = {rows * 512 * 4 / ms / 1e6:.2f} GB/s [{card}]")


# phase 10: a rank of a two-process CLI run. argv: the JSON file for this
# process's counts, "hop" or "-", then the CLI's arguments. Every count is
# set to 0 before cli.main; the library that allgather_library returns
# is kept for the check.
RANK_DRIVER = r"""
import json, sys, time
sys.path.insert(0, {here!r})
import numpy as np
import chip_smoke as cs
from fedrann_tpu_torch import cli
from fedrann_tpu_torch.parallel import runtime
cs.register_counters()
libs = []
gather = runtime.allgather_library
def keep(*args, **kwargs):
    libs.append(gather(*args, **kwargs))
    return libs[-1]
runtime.allgather_library = keep
out, hop, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
extra = {{}}
if hop == "hop":
    extra["hop"] = cs.time_hop(cli.config_from_args(argv))
cs.reset_counts()
rc = cli.main(argv)
extra.update(kernels=cs.read_counts(cs.COUNTERS),
             host=cs.read_counts(cs.HOST_COUNTERS))
if libs:
    codes, counts = libs[-1].numpy()
    np.savez(out.replace(".json", ".library.npz"), codes=codes,
             counts=counts)
with open(out, "w") as f:
    json.dump(extra, f)
sys.exit(rc)
"""


def time_hop(config) -> dict:
    """Phase 10e, in each rank before its run: one (HOP_ROWS, 512) float32
    block sent to the next rank and one received, over the transport the
    runtime chooses for these cards, timed after a warm-up (host clock
    around a synchronized exchange, the best of HOP_REPS)."""
    import torch

    from fedrann_tpu_torch.parallel.dist import (
        DeviceTransport,
        initialize_distributed,
    )

    group = initialize_distributed(config.coordinator, config.num_processes,
                                   config.process_id)
    dev = torch.device("cuda", 0)
    transport = DeviceTransport(group, [dev])
    block = torch.randn((HOP_ROWS, 512), device=dev)
    peer_to = (group.rank + 1) % group.size
    peer_from = (group.rank - 1) % group.size
    best = float("inf")
    for _ in range(HOP_REPS + 1):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        [got] = transport.exchange([(peer_to, block)],
                                   [(peer_from, block.shape, dev)])
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    if not torch.isfinite(got).all():
        fail("10e: the received block is not finite")
    return {"kind": transport.kind, "bytes": block.numel() * 4,
            "seconds": best}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def drive_ranks(fasta: str, out_dir: str, flags: list[str],
                env_by_rank: list[dict], hop: bool = False) -> tuple:
    """Two processes of the CLI (RANK_DRIVER) on `fasta` with `flags`,
    --num-processes 2 at a coordinator on localhost, each with its env
    additions; both are killed if they outlast RANK_TIMEOUT. Returns
    (wall seconds, each rank's counts JSON, each rank's log text)."""
    os.makedirs(out_dir, exist_ok=True)
    coord = f"127.0.0.1:{free_port()}"
    procs, logs, jsons = [], [], []
    t0 = time.perf_counter()
    for rank, extra in enumerate(env_by_rank):
        jsons.append(os.path.join(out_dir, f"counts.rank{rank}.json"))
        logs.append(os.path.join(out_dir, f"rank{rank}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_DRIVER.format(here=HERE),
                 jsons[-1], "hop" if hop else "-", "-i", fasta, "-o",
                 out_dir, *flags, "--num-processes", "2", "--process-id",
                 str(rank), "--coordinator", coord],
                env={**os.environ, **extra}, stdout=f,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"10: a rank outlasted {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for rank, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            texts.append(f.read())
        if p.returncode != 0:
            fail(f"10: rank {rank} exited {p.returncode}:\n"
                 f"{texts[-1][-3000:]}")
    counts = []
    for path in jsons:
        with open(path) as f:
            counts.append(json.load(f))
    return wall, counts, texts


def check_ranks(label: str, fasta: str, out_dir: str, sim, flags: list[str],
                paths: set, ref: dict, card: str, transport: str = "gloo",
                env_by_rank=None, loads=("parse", "cache"),
                resumed: bool = False, keep: bool = False,
                hop: bool = False, min_recall: float = MIN_RECALL,
                min_agree: float = MULTI_AGREE) -> dict:
    """One phase 10 run: two ranks of the CLI (drive_ranks), checked as
    9b: both exit 0; each rank launched K1+K2 (a fused staging kernel) and
    K3 and no staging kernel outside `paths` (none of either when
    `resumed`), K5 (the sign table, every run), no K8, and K4, K6, K7 and
    K9 (as knn_expected says for `flags`; K9 on rank 0 alone), loaded as
    `loads` says (rank 0 first: "parse" a native parse, "cache" one
    fxcache.npz load, "ranged" a byte-range parse) with no Python reader
    or packer and no pinning copy; both gathered the
    single-process library `ref["library"]`; the merged overlaps.tsv
    holds truth recall >= min_recall and agreement >= min_agree with the
    table of `ref["sets"]` (phase 4's); the rank tables are gone (kept
    with `keep`);
    metrics.rank<r>.json holds the seven stages (no "stage" when
    resumed) and the transport, which the log names too. Returns the
    kernel launches of both ranks summed."""
    import numpy as np

    wall, counts, logs = drive_ranks(
        fasta, out_dir, flags, env_by_rank or [{}, {}], hop)
    want_stages = [s for s in STAGES if not (resumed and s == "stage")]
    totals: dict = {}
    rank_secs = []
    for rank, (c, text) in enumerate(zip(counts, logs)):
        kernels, host = c["kernels"], c["host"]
        staging = {k for k in STAGE_KERNELS if kernels[k] > 0}
        if resumed:
            if staging or kernels["membership_embed"]:
                fail(f"{label} rank {rank}: a resumed run launched {kernels}")
            if "resuming embeddings" not in text:
                fail(f"{label} rank {rank}: no embeddings resumed")
        elif not (staging & {"stage_rows_packed", "stage_rows_bits"}) \
                or not staging <= paths or not kernels["membership_embed"]:
            fail(f"{label} rank {rank}: launches {kernels}, staging kernels "
                 f"{staging} not within {paths} or K1+K2 / K3 missing")
        knn = knn_expected(flags)
        # rank 0 alone runs the k-means (knn_ivf_sharded_multihost)
        knn["ivf_segment_sum"] = knn["ivf_segment_sum"] and rank == 0
        if not kernels["srp_signs"] or kernels["srp_paired"] or any(
                (kernels[name] > 0) != want for name, want in knn.items()):
            fail(f"{label} rank {rank}: launches {kernels}, K5 missing, K8 "
                 f"launched or the k-NN kernels not as {knn}")
        check_k11(kernels, knn["ivf_rescore"], f"{label} rank {rank}")
        want = {"read_fastx": 0, "pack_reads": 0, "pin_copies": 0,
                "pack_reads_native": int(loads[rank] in ("parse", "ranged")),
                "cache_hits": int(loads[rank] == "cache")}
        wrong = {k: host[k] for k, v in want.items() if host[k] != v}
        if wrong:
            fail(f"{label} rank {rank}: host counts {wrong}, want {want}")
        if f"device transport: {transport}" not in text:
            fail(f"{label} rank {rank}: the log names no {transport} "
                 "transport")
        if loads[rank] == "ranged" and "byte-range parse" not in text:
            fail(f"{label} rank {rank}: no byte-range parse")
        if not resumed:
            lib = np.load(os.path.join(out_dir,
                                       f"counts.rank{rank}.library.npz"))
            if not (np.array_equal(lib["codes"], ref["library"][0])
                    and np.array_equal(lib["counts"], ref["library"][1])):
                fail(f"{label} rank {rank}: the gathered library differs "
                     "from the single-process one")
        with open(os.path.join(out_dir, f"metrics.rank{rank}.json")) as f:
            stages = json.load(f)
        missing = [s for s in want_stages if s not in stages]
        if missing or stages["transport"]["kind"] != transport:
            fail(f"{label} rank {rank}: metrics.rank{rank}.json lacks "
                 f"{missing} or names transport {stages['transport']}")
        rank_secs.append(
            f"rank {rank} on {','.join(stages['transport']['cards'])}: "
            + ", ".join(f"{s} {stages[s]['seconds']:.3f}"
                        for s in want_stages)
            + "; " + roofline(stages))
        for name, n in kernels.items():
            totals[name] = totals.get(name, 0) + n
    tsv = os.path.join(out_dir, "overlaps.tsv")
    for rank in range(2):
        if os.path.exists(os.path.join(
                out_dir, f"overlaps.rank{rank}.tsv")) != keep:
            fail(f"{label}: overlaps.rank{rank}.tsv "
                 f"{'missing' if keep else 'not removed'}")
    recall = check_truth_recall(tsv, sim, MIN_OVERLAP, f"{label} ",
                                min_recall)
    agree = table_agreement(tsv, ref["sets"])
    if agree < min_agree:
        fail(f"{label}: agreement {agree:.5f} with the reference table "
             f"below {min_agree}")
    hops = [c["hop"] for c in counts if "hop" in c]
    log(f"{label}: 2 ranks, {wall:.2f} s wall ({len(sim.names) / wall:.1f} "
        f"reads/s), transport {transport}; " + "; ".join(rank_secs)
        + f"; truth recall {recall:.4f}, agreement with the reference "
        f"table {agree:.5f}; launches {totals}"
        + "".join(f"; hop {h['kind']} {h['bytes']} bytes in "
                  f"{h['seconds'] * 1e3:.3f} ms = "
                  f"{h['bytes'] / h['seconds'] / 1e9:.2f} GB/s"
                  for h in hops) + f" [{card}]")
    return totals


def check_multiprocess(fasta: str, out_dir: str, sim, card: str, dev,
                       phase4_tsv: str, library_npz: str) -> dict:
    """Phase 10: phase 4's reads and flags through the CLI in two rank
    processes (check_ranks): (a) the shared fxcache.npz with ring, (b)
    --no-pack-cache (each rank parses its byte range) with allgather, (c)
    ring2d, then FEDRANN_TPU_MULTIHOST_KNN=host, (d) --keep-intermediates,
    then a resumed rerun (no staging kernel, no kernel C, byte-identical
    overlaps.tsv); on one card both ranks share it (gloo through pinned
    host memory). (e) only with two or more cards: each rank on its own
    card by CUDA_VISIBLE_DEVICES, the transport NCCL, one hop's GB/s;
    with four or more, also two cards a rank with ring2d, ring and
    allgather. Returns the
    kernel launches of every run summed."""
    import numpy as np
    import torch

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().replace("\n", ", ")
    log(f"10: compute mode {mode}; {torch.cuda.device_count()} visible "
        f"card(s) [{card}]")
    lib = np.load(library_npz)
    ref = {"library": (lib["codes"], lib["counts"]),
           "sets": overlap_sets(phase4_tsv)}
    paths = stage_paths(sim, FLAGS, dev)
    totals: dict = {}

    def run(label, sub, flags, **kw):
        for name, n in check_ranks(label, fasta, os.path.join(out_dir, sub),
                                   sim, [*FLAGS, *flags], paths, ref, card,
                                   **kw).items():
            totals[name] = totals.get(name, 0) + n

    run("10a ring, shared cache", "a", ["--knn-shard-strategy", "ring"])
    run("10b allgather, byte-range parse", "b",
        ["--no-pack-cache", "--knn-shard-strategy", "allgather"],
        loads=("ranged", "ranged"))
    run("10c ring2d", "c2d", ["--knn-shard-strategy", "ring2d"])
    run("10c FEDRANN_TPU_MULTIHOST_KNN=host", "chost", [],
        env_by_rank=[{"FEDRANN_TPU_MULTIHOST_KNN": "host"}] * 2)
    run("10d --keep-intermediates", "d", ["--keep-intermediates"], keep=True)
    tsv = os.path.join(out_dir, "d", "overlaps.tsv")
    with open(tsv, "rb") as f:
        first = f.read()
    run("10d resumed", "d", ["--keep-intermediates"], keep=True,
        resumed=True, loads=("cache", "cache"))
    with open(tsv, "rb") as f:
        if f.read() != first:
            fail("10d: the resumed run's overlaps.tsv differs")
    if torch.cuda.device_count() >= 2:
        run("10e ring, one card a rank", "e", [], transport="nccl",
            env_by_rank=[{"CUDA_VISIBLE_DEVICES": str(r)} for r in (0, 1)],
            hop=True)
    if torch.cuda.device_count() >= 4:
        # two cards a rank: a block moves between a rank's cards by
        # to_device and leaves the rank from its first card; allgather
        # gathers each rank's shards there first
        for strategy in ("ring2d", "ring", "allgather"):
            run(f"10e {strategy}, two cards a rank", f"e2{strategy}",
                ["--knn-shard-strategy", strategy], transport="nccl",
                env_by_rank=[{"CUDA_VISIBLE_DEVICES": "0,1"},
                             {"CUDA_VISIBLE_DEVICES": "2,3"}])
    if torch.cuda.device_count() < 2:
        log("10e: one card; the NCCL transport between ranks on distinct "
            f"cards needs two [{card}]")
    return totals


def check_ooc_profile(fasta: str, out_dir: str, in_core_tsv: str, sim,
                      card: str, dev) -> dict:
    """8a's CLI run again under --profile: the out-of-core merges (K4
    launches, one a query slab and candidate block) inside a
    torch.profiler session; checked
    as phase 4 (drive_cli), the trace must exist and hold device activity,
    the plan's slabs must upload, and agreement with phase 4's in-core
    table >= OOC_AGREE_CLI. Returns the launch counts."""
    flags = [*FLAGS, "--knn-hbm-budget", OOC_CLI_BUDGET, "--profile"]
    launches, secs = drive_cli(fasta, out_dir, sim, MIN_OVERLAP, card, dev,
                               flags)
    host = read_counts(HOST_COUNTERS)
    trace = os.path.join(out_dir, "trace", "trace.json")
    if not os.path.exists(trace) or host["ooc_slabs"] < 2:
        fail(f"8a --profile: trace {os.path.exists(trace)}, "
             f"{host['ooc_slabs']} slabs")
    busy_us, n = device_busy_us(trace)
    agree = table_agreement(os.path.join(out_dir, "overlaps.tsv"),
                            overlap_sets(in_core_tsv))
    log(f"8a --profile: {host['ooc_slabs']} slabs, {host['ooc_blocks']} "
        f"blocks; device busy {busy_us / 1e3:.3f} ms over {n} kernels and "
        f"copies; knn {secs['knn']:.3f} s; agreement {agree:.5f} [{card}]")
    if n == 0 or agree < OOC_AGREE_CLI:
        fail(f"8a --profile: {n} device events, agreement {agree:.5f}")
    return launches


def overlap_rows(n_rows: int, dev):
    """(n_rows, 512) float32 rows of read-overlap geometry on `dev`
    (bench/configs.py's dmel shape), from FLAGS' --seed: a genome of
    IVF_GENOME bases cut into IVF_TILE-base tiles, each strand's tiles
    Gaussian d = 512 vectors; n_rows / 2 reads of IVF_READ_LEN +- 20%
    bases at uniform starts on a random strand; a read's first row sums
    its strand's tiles over its span (a cumulative-sum difference), its
    second the other strand's, each plus N(0, 1) noise a coordinate."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(int(FLAGS[FLAGS.index("--seed") + 1]))
    n_reads, d, n_tiles = n_rows // 2, 512, IVF_GENOME // IVF_TILE
    cums = []
    for _ in range(2):
        tiles = torch.randn((n_tiles, d), generator=g, device=dev)
        cums.append(torch.cat([tiles.new_zeros((1, d)),
                               torch.cumsum(tiles, 0)]))
        del tiles
    span = (IVF_READ_LEN / IVF_TILE * (0.8 + 0.4 * torch.rand(
        n_reads, generator=g, device=dev))).long()
    start = (torch.rand(n_reads, generator=g, device=dev)
             * (n_tiles - span)).long()
    on = [c[start + span] - c[start] for c in cums]
    strand = torch.randint(0, 2, (n_reads, 1), generator=g, device=dev) == 0
    rows = torch.stack([torch.where(strand, on[0], on[1]),
                        torch.where(strand, on[1], on[0])], dim=1)
    return (rows.reshape(n_rows, d)
            + torch.randn((n_rows, d), generator=g, device=dev))


def sample_recall(idx, ref, sample) -> float:
    """Mean over the sampled rows of |idx[r] & ref[r]| / k (an unset -1
    slot matches nothing)."""
    return float(sum(len(set(idx[r].tolist()) & set(ref[r].tolist()))
                     for r in sample) / (len(sample) * ref.shape[1]))


def check_ivf_rows(label: str, idx, dist, rows, precision: str = "bf16"):
    """An IVF search's output contract on `rows` (on the card): self at
    rank 0 (no row is zero), every row sorted, no index twice in a row,
    and every returned distance within 1e-5 of a recompute on the rows as
    the search scores them (topk.unit_rows). Returns the largest error."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn.topk import unit_rows

    n = rows.shape[0]
    srt = np.sort(idx, axis=1)
    if not (idx[:, 0] == np.arange(n)).all() \
            or not (np.diff(dist, axis=1) >= 0).all() \
            or ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any():
        fail(f"{label}: self not at rank 0 in "
             f"{(idx[:, 0] != np.arange(n)).sum()} rows, unsorted rows or "
             "an index twice in a row")
    en = unit_rows(rows, precision)
    err = 0.0
    for r0 in range(0, n, 8192):
        ix = torch.from_numpy(idx[r0 : r0 + 8192]).to(rows.device).long()
        got = torch.from_numpy(dist[r0 : r0 + 8192]).to(rows.device)
        true = 1.0 - torch.einsum("rd,rkd->rk", en[r0 : r0 + 8192],
                                  en[ix.clamp_min(0)])
        err = max(err, float((got - true).abs()[ix >= 0].max()))
    if err > 1e-5:
        fail(f"{label}: a distance {err:.3g} from its recompute (> 1e-5)")
    return err


def check_ivf_cli(fasta: str, out_dir: str, sim, card: str, dev,
                  phase4_tsv: str) -> tuple[dict, str]:
    """Phase 11a: phase 4's reads through the CLI with --knn-method ivf
    (auto C, p = 8, spill 2; --knn-sharded never where more than one card
    is visible), checked as phase 4 (drive_cli) at truth
    recall >= IVF_RECALL: knn_ivf called once, past its valve, with C =
    256; agreement with phase 4's exact table logged; a second run on a
    fresh -o must write a byte-identical overlaps.tsv; a run with C = p =
    16 must agree >= IVF_AGREE_ALL with phase 4's table; a run at
    --knn-precision fp32 (K6's fp32 form) is checked as phase 4, its
    agreement with the first run's table logged. Every run launches K4
    (the k-means and cluster ranking), K6 and K7 (knn_expected). Returns
    the launch counts of the four runs summed and the first run's
    overlaps.tsv path."""
    import torch

    from fedrann_tpu_torch.knn.ivf import knn_ivf

    theirs = overlap_sets(phase4_tsv)
    flags = [*FLAGS, "--knn-method", "ivf"]
    if torch.cuda.device_count() > 1:  # auto would shard over the cards
        flags += ["--knn-sharded", "never"]
    totals: dict = {}
    paths = []
    for label, extra in (("11a", []), ("11a again", []),
                         ("11a C = p = 16", ["--knn-ivf-clusters", "16",
                                             "--knn-ivf-probes", "16"]),
                         ("11a fp32", ["--knn-precision", "fp32"])):
        out = os.path.join(out_dir, str(len(paths)))
        launches, secs = drive_cli(fasta, out, sim, MIN_OVERLAP, card, dev,
                                   [*flags, *extra], min_recall=IVF_RECALL)
        host = read_counts(HOST_COUNTERS)
        last = knn_ivf.last
        every = "--knn-ivf-clusters" in extra
        if (host["ivf_calls"], host["ivf_fallbacks"]) != (1, 0) \
                or last["clusters"] != (16 if every else 256):
            fail(f"{label}: knn_ivf calls / fallbacks "
                 f"{host['ivf_calls']} / {host['ivf_fallbacks']} (want 1 / "
                 f"0), C = {last['clusters']}")
        paths.append(os.path.join(out, "overlaps.tsv"))
        agree = table_agreement(paths[-1], theirs)
        log(f"{label} --knn-method ivf {' '.join(extra)}: C = "
            f"{last['clusters']}, p = {last['probes']}, spill "
            f"{last['spill']}, {last['size_classes']} size classes, "
            f"{last['pair_scores']:.4g} padded pair-scores, "
            f"{last['real_pair_scores']:.4g} real; K4 {launches['knn_merge']}"
            f", K6 {launches['ivf_rescore']} ({launches['ivf_rescore_fp32']} "
            f"fp32), K7 {launches['ivf_merge']} launches; knn "
            f"{secs['knn']:.3f} s; neighbor agreement with phase 4's exact "
            f"table {agree:.5f}"
            + (f", with 11a's {table_agreement(paths[-1], overlap_sets(paths[0])):.5f}"
               if len(paths) > 1 else "") + f" [{card}]")
        if every and agree < IVF_AGREE_ALL:
            fail(f"{label}: agreement {agree:.5f} with phase 4 below "
                 f"{IVF_AGREE_ALL}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        if f.read() != g.read():
            fail("11a: two IVF runs wrote different overlaps.tsv")
    log("11a: the two IVF runs' overlaps.tsv are byte-identical")
    return totals, paths[0]


# 11b's knn_ivf split by step: the knn/ivf.py functions each step calls,
# as (function, step); _top_clusters is the k-means assignment with t = 1
# and the spill/probe ranking otherwise; K11's two launches
# (bucket_clusters: the member side, then the probe side inside the
# rescore)
IVF_STEPS = (("_top_clusters", None), ("_segment_sum", "segment sums"),
             ("bucket_clusters", "member and probe sides (K11)"),
             ("_rescore", "rescore"), ("_merge_buffers", "merge"),
             ("keys_to_host", "keys_to_host"))


class Forwarding:
    """`call` in place of fn, fn's attributes (its launch counters) read
    and written on fn itself."""

    def __init__(self, fn, call):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_call", call)

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def ivf_step_split():
    """Inside: each call of an IVF_STEPS function in knn/ivf.py timed by
    CUDA events (device time from its first to its last launch) and by
    the host clock, each between two synchronizes, less the time of the
    steps it calls (the rescore holds the probe tables and the merge).
    Yields {step: [event ms, host ms, calls]}, "k-means assignment" and
    "spill/probe ranking" for _top_clusters by its t."""
    import torch

    from fedrann_tpu_torch.knn import ivf

    split: dict = {}
    stack: list = []
    saved = {name: getattr(ivf, name) for name, _ in IVF_STEPS}

    def timed(name, step, fn):
        def run(*args, **kwargs):
            label = step or ("k-means assignment" if args[2] == 1
                             else "spill/probe ranking")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stack.append([0.0, 0.0])
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            dev = start.elapsed_time(end)
            inner = stack.pop()
            row = split.setdefault(label, [0.0, 0.0, 0])
            row[0] += dev - inner[0]
            row[1] += host - inner[1]
            row[2] += 1
            if stack:
                stack[-1][0] += dev
                stack[-1][1] += host
            return out
        return Forwarding(fn, run)

    for name, step in IVF_STEPS:
        setattr(ivf, name, timed(name, step, saved[name]))
    try:
        yield split
    finally:
        for name, fn in saved.items():
            setattr(ivf, name, fn)


def log_ivf_split(label: str, split: dict, total_ms: float,
                  card: str) -> None:
    """One line: each step's event and host milliseconds and calls, and
    the rest of total_ms (the host clock around the search)."""
    steps = sum(v[1] for v in split.values())
    log(f"{label} split by step (event ms / host ms, calls): " + "; ".join(
        f"{k} {v[0]:.3f} / {v[1]:.3f} ({v[2]})" for k, v in split.items())
        + f"; the rest (normalize, centroid updates, bincounts, syncs) "
        f"{total_ms - steps:.3f} host ms of {total_ms:.3f} [{card}]")


@contextlib.contextmanager
def no_sync_until_k6():
    """Inside: from knn/ivf.py _tables' return until K6's launch
    (fk_ivf_rescore), torch.cuda.set_sync_debug_mode("error"), so a
    synchronizing call there raises. Yields the spans seen ("open",
    "closed" for each search)."""
    import torch

    from fedrann_tpu_torch import _build
    from fedrann_tpu_torch.knn import ivf

    tables, launch = ivf._tables, _build.launch
    spans: list = []

    def after_tables(*args, **kwargs):
        out = tables(*args, **kwargs)
        torch.cuda.set_sync_debug_mode("error")
        spans.append("open")
        return out

    def then_k6(name, *args, **kwargs):
        try:
            return launch(name, *args, **kwargs)
        finally:
            if name == "fk_ivf_rescore":
                torch.cuda.set_sync_debug_mode("default")
                spans.append("closed")

    ivf._tables, _build.launch = after_tables, then_k6
    try:
        yield spans
    finally:
        torch.cuda.set_sync_debug_mode("default")
        ivf._tables, _build.launch = tables, launch


def pinned_bytes() -> str:
    """The bytes torch's caching host allocator keeps page-locked (its
    blocks, in use or cached: K10's results and the IVF bounds' copies
    among them), as torch.cuda.host_memory_stats reports them."""
    import torch

    stats = (torch.cuda.host_memory_stats()
             if hasattr(torch.cuda, "host_memory_stats") else {})
    got = stats.get("allocated_bytes.current")
    return ("not reported" if got is None else
            f"{got} bytes in {stats.get('allocations.current')} blocks")


def check_ivf_search(dev, card: str) -> dict:
    """Phase 11b: knn_ivf on IVF_ROWS x 512 rows of read-overlap geometry
    (overlap_rows), k = IVF_K: cold and warm seconds beside knn_exact's
    on the same rows, C, p, spill, the size classes and padded
    pair-scores, recall against knn_exact on IVF_SAMPLE sampled queries;
    the output contract (check_ivf_rows). Returns what 11c compares
    with: the rows, the sample, the exact neighbors and the recall."""
    import numpy as np

    from fedrann_tpu_torch.knn.ivf import knn_ivf
    from fedrann_tpu_torch.knn.topk import knn_exact

    t0 = time.perf_counter()
    rows = overlap_rows(IVF_ROWS, dev)
    made = time.perf_counter() - t0
    (ref, _), exact_secs, _ = measured(
        lambda: knn_exact(rows, IVF_K, transfer="f32"), [dev])
    _, cold, _ = measured(lambda: knn_ivf(rows, IVF_K, transfer="f32"),
                          [dev])
    (idx, dist), warm, peak = measured(
        lambda: knn_ivf(rows, IVF_K, transfer="f32"), [dev])
    last = knn_ivf.last
    with ivf_step_split() as split:
        (idx2, _), split_secs, _ = measured(
            lambda: knn_ivf(rows, IVF_K, transfer="f32"), [dev])
    if not np.array_equal(idx, idx2):
        fail("11b: knn_ivf gave other neighbors under the step split")
    with no_sync_until_k6() as spans:
        idx3, _ = knn_ivf(rows, IVF_K, transfer="f32")
    if spans != ["open", "closed"] or not np.array_equal(idx, idx3):
        fail(f"11b: the no-sync run saw spans {spans} or gave other "
             "neighbors")
    log("11b: a warm knn_ivf under torch.cuda.set_sync_debug_mode('error') "
        "from _tables' return until K6's launch made no synchronizing call "
        f"[{card}]")
    log_ivf_split("11b knn_ivf", split, split_secs * 1e3, card)
    seg = split["segment sums"]
    log(f"11b segment sums (K9): {seg[0]:.3f} event ms / {seg[1]:.3f} host "
        f"ms over {seg[2]} calls; by torch ops before K9 "
        f"{SEGMENT_TORCH_OPS_MS[0]}-{SEGMENT_TORCH_OPS_MS[1]} event ms over "
        f"3 [{card}]")
    rng = np.random.default_rng(int(FLAGS[FLAGS.index("--seed") + 1]))
    sample = np.sort(rng.choice(IVF_ROWS, IVF_SAMPLE, replace=False))
    recall = sample_recall(idx, ref, sample)
    err = check_ivf_rows("11b", idx, dist, rows)
    log(f"11b knn_ivf on {IVF_ROWS} x 512 read-overlap rows (made in "
        f"{made:.2f} s), k = {IVF_K}: C = {last['clusters']}, p = "
        f"{last['probes']}, spill {last['spill']}, largest cluster "
        f"{last['max_members']} rows, {last['size_classes']} size classes "
        f"over {last['probed_clusters']} probed clusters, "
        f"{last['pair_scores']:.4g} padded pair-scores "
        f"({IVF_ROWS ** 2 / last['pair_scores']:.2f}x fewer than exact), "
        f"{last.get('real_pair_scores', float('nan')):.4g} real; "
        f"{warm:.3f} s warm, {cold:.3f} s cold, against knn_exact "
        f"{exact_secs:.3f} s ({exact_secs / warm:.2f}x); peak {peak} bytes; "
        f"recall against knn_exact on {IVF_SAMPLE} sampled queries "
        f"{recall:.5f}; distances within {err:.3g} of a recompute [{card}]")
    if recall < IVF_SEARCH_RECALL:
        fail(f"11b: recall {recall:.5f} below {IVF_SEARCH_RECALL:.5f}")
    return {"rows": rows, "sample": sample, "ref": ref, "recall": recall,
            "secs": warm}


def check_ivf_ooc(fasta: str, out_dir: str, sim, card: str, dev,
                  ivf_tsv: str, b: dict, exact_ooc_secs: float) -> dict:
    """Phase 11c: knn_ivf_ooc. (a)'s CLI run at --knn-hbm-budget
    OOC_CLI_BUDGET, checked as phase 4 at truth recall >= IVF_RECALL:
    knn_ivf_ooc called once and knn_ivf not; agreement with 11a's table
    logged. Then on 11b's rows at OOC_BUDGET bytes: recall on 11b's
    sampled queries >= 11b's - 0.01; its seconds beside 8b's
    knn_exact_ooc and 11b's knn_ivf, the blocks uploaded against exact
    out-of-core's, the dropped-vote share and the peak device memory
    against the budget logged. Returns the CLI run's launch counts."""
    from fedrann_tpu_torch.knn.ooc import knn_ivf_ooc

    flags = [*FLAGS, "--knn-method", "ivf", "--knn-hbm-budget",
             OOC_CLI_BUDGET]
    launches, secs = drive_cli(fasta, out_dir, sim, MIN_OVERLAP, card, dev,
                               flags, min_recall=IVF_RECALL)
    host = read_counts(HOST_COUNTERS)
    if (host["ivf_ooc_calls"], host["ivf_calls"]) != (1, 0):
        fail(f"11c: knn_ivf_ooc called {host['ivf_ooc_calls']} times, "
             f"knn_ivf {host['ivf_calls']} (want 1, 0)")
    last = knn_ivf_ooc.last
    agree = table_agreement(os.path.join(out_dir, "overlaps.tsv"),
                            overlap_sets(ivf_tsv))
    log(f"11c --knn-method ivf --knn-hbm-budget {OOC_CLI_BUDGET}: "
        f"{last['slabs']} slabs, {last['uploads']} of {last['exact_uploads']}"
        f" candidate blocks uploaded, {last['dropped_votes']} of "
        f"{last['votes']} probe votes dropped; knn {secs['knn']:.3f} s; "
        f"neighbor agreement with 11a's table {agree:.5f} [{card}]")

    rows = b["rows"].cpu().numpy()
    (idx, _), ooc_secs, peak = measured(
        lambda: knn_ivf_ooc(rows, IVF_K, OOC_BUDGET, transfer="f32",
                            device=dev), [dev])
    last = knn_ivf_ooc.last
    recall = sample_recall(idx, b["ref"], b["sample"])
    log(f"11c knn_ivf_ooc on 11b's rows at {OOC_BUDGET} bytes: "
        f"{ooc_secs:.3f} s against 8b's knn_exact_ooc {exact_ooc_secs:.3f} s"
        f" (other rows, same size) and 11b's in-core knn_ivf "
        f"{b['secs']:.3f} s; C = {last['clusters']}, {last['sample_rows']} "
        f"k-means rows, {last['slabs']} slabs x {last['q_rows']} rows, "
        f"{last['blocks']} blocks x {last['c_rows']} rows: "
        f"{last['uploads']} block uploads against exact out-of-core's "
        f"{last['exact_uploads']}, "
        f"{100.0 * last['dropped_votes'] / max(last['votes'], 1):.3f}% of "
        f"probe votes dropped; peak {peak} bytes against the "
        f"{OOC_BUDGET}-byte budget; recall on 11b's {IVF_SAMPLE} queries "
        f"{recall:.5f} (11b {b['recall']:.5f}) [{card}]")
    if recall < b["recall"] - 0.01:
        fail(f"11c: recall {recall:.5f} below 11b's {b['recall']:.5f} - "
             "0.01")
    return launches


def check_ivf_sharded(fasta: str, out_dir: str, sim, card: str, dev,
                      ivf_tsv: str) -> dict:
    """Phase 11d: knn_ivf_sharded over SHARD_ENTRIES entries of the card
    (and with two or more cards, over every card) on IVF_SHARD_ROWS x 512
    rows of 11b's structure: the output contract (check_ivf_rows), recall
    against knn_exact >= one-card knn_ivf's - 0.02 (on IVF_SAMPLE sampled
    queries), the agreement of the two, and each one's cold and warm
    seconds logged. Then phase 4's reads through the CLI with
    --knn-sharded always --knn-method ivf, checked as phase 4 at truth
    recall >= IVF_RECALL: knn_ivf_sharded called once, and knn_ivf once
    by it (the search over the mesh);
    agreement >= IVF_AGREE with 11a's table (byte-identical or not,
    logged). Returns the CLI run's launch counts."""
    import numpy as np

    from fedrann_tpu_torch.knn.ivf import knn_ivf, knn_ivf_sharded
    from fedrann_tpu_torch.knn.topk import knn_exact
    from fedrann_tpu_torch.parallel.mesh import make_mesh

    import torch

    rows = overlap_rows(IVF_SHARD_ROWS, dev)
    ref, _ = knn_exact(rows, IVF_K, transfer="f32")
    rng = np.random.default_rng(int(FLAGS[FLAGS.index("--seed") + 1]))
    sample = np.sort(rng.choice(IVF_SHARD_ROWS, IVF_SAMPLE, replace=False))

    def run(fn, devices, label):
        _, cold, _ = measured(fn, devices)
        (idx, dist), warm, _ = measured(fn, devices)
        check_ivf_rows(label, idx, dist, rows)
        return idx, cold, warm, sample_recall(idx, ref, sample)

    one, c1, w1, r1 = run(lambda: knn_ivf(rows, IVF_K, transfer="f32"),
                          [dev], "11d knn_ivf")
    meshes = [(f"{SHARD_ENTRIES} entries of {dev}", [dev] * SHARD_ENTRIES)]
    if torch.cuda.device_count() >= 2:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        meshes.append((f"{len(cards)} cards", cards))
    for label, devices in meshes:
        mesh = make_mesh(devices=devices)
        sh, c4, w4, r4 = run(lambda mesh=mesh: knn_ivf_sharded(
            rows, IVF_K, mesh=mesh, transfer="f32"), devices,
            f"11d knn_ivf_sharded over {label}")
        log(f"11d knn_ivf_sharded over {label}, {IVF_SHARD_ROWS} x 512 "
            f"rows, k = {IVF_K}, C = {knn_ivf_sharded.last['clusters']}: "
            f"{w4:.3f} s warm ({c4:.3f} s cold) against one-card knn_ivf "
            f"{w1:.3f} s ({c1:.3f} s cold); recall against knn_exact on "
            f"{IVF_SAMPLE} queries {r4:.5f} (one card {r1:.5f}); agreement "
            f"of the two over every row {set_agreement(sh, one):.6f}, "
            f"{'equal' if np.array_equal(sh, one) else 'not equal'}; "
            f"page-locked by torch's host cache: {pinned_bytes()} "
            f"[{card}]")
        if r4 < r1 - 0.02:
            fail(f"11d over {label}: sharded recall {r4:.5f} below one "
                 f"card's {r1:.5f} - 0.02")

    launches, secs = drive_cli(
        fasta, out_dir, sim, MIN_OVERLAP, card, dev,
        [*FLAGS, "--knn-sharded", "always", "--knn-method", "ivf"],
        min_recall=IVF_RECALL)
    host = read_counts(HOST_COUNTERS)
    if (host["ivf_sharded_calls"], host["ivf_calls"]) != (1, 1):
        fail(f"11d: knn_ivf_sharded called {host['ivf_sharded_calls']} "
             f"times, knn_ivf {host['ivf_calls']} (want 1, 1)")
    path = os.path.join(out_dir, "overlaps.tsv")
    agree = table_agreement(path, overlap_sets(ivf_tsv))
    with open(path, "rb") as f, open(ivf_tsv, "rb") as g:
        same = f.read() == g.read()
    log(f"11d --knn-sharded always --knn-method ivf: knn_ivf_sharded over "
        f"{knn_ivf_sharded.last.get('entries')} card(s); knn "
        f"{secs['knn']:.3f} s; agreement with 11a's table {agree:.5f}, "
        f"{'byte-identical' if same else 'not byte-identical'} [{card}]")
    if agree < IVF_AGREE:
        fail(f"11d: agreement {agree:.5f} with 11a below {IVF_AGREE}")
    return launches


def check_ivf_ranks(fasta: str, out_dir: str, sim, card: str, dev,
                    ivf_tsv: str, library_npz: str) -> dict:
    """Phase 11e: phase 4's reads through the CLI with --knn-method ivf
    in two rank processes, checked as phase 10 (check_ranks) at truth
    recall >= IVF_RECALL and agreement >= IVF_AGREE with 11a's table:
    gloo on one card; with two or more cards also one card a rank over
    NCCL, and with four or more two cards a rank. Each rank must have
    called knn_ivf_sharded_multihost once.
    Returns the kernel launches of the runs summed."""
    import numpy as np
    import torch

    lib = np.load(library_npz)
    ref = {"library": (lib["codes"], lib["counts"]),
           "sets": overlap_sets(ivf_tsv)}
    paths = stage_paths(sim, FLAGS, dev)
    runs = [("11e two ranks, --knn-method ivf", "gloo", "one", None)]
    if torch.cuda.device_count() >= 2:
        runs.append(("11e two ranks, one card a rank, --knn-method ivf",
                     "nccl", "two",
                     [{"CUDA_VISIBLE_DEVICES": str(r)} for r in (0, 1)]))
    if torch.cuda.device_count() >= 4:
        runs.append(("11e two ranks, two cards a rank, --knn-method ivf",
                     "nccl", "four", [{"CUDA_VISIBLE_DEVICES": "0,1"},
                                      {"CUDA_VISIBLE_DEVICES": "2,3"}]))
    totals: dict = {}
    for label, transport, sub, env in runs:
        out = os.path.join(out_dir, sub)
        for name, n in check_ranks(
                label, fasta, out, sim, [*FLAGS, "--knn-method", "ivf"],
                paths, ref, card, transport=transport, env_by_rank=env,
                min_recall=IVF_RECALL, min_agree=IVF_AGREE).items():
            totals[name] = totals.get(name, 0) + n
        for rank in range(2):
            with open(os.path.join(out, f"counts.rank{rank}.json")) as f:
                calls = json.load(f)["host"]["ivf_multihost_calls"]
            if calls != 1:
                fail(f"{label} rank {rank}: knn_ivf_sharded_multihost "
                     f"called {calls} times")
    return totals


def check_ivf(fasta: str, out_dir: str, sim, card: str, dev,
              phase4_tsv: str, library_npz: str,
              exact_ooc_secs: float) -> dict:
    """Phase 11, the IVF k-NN on every path: 11a in core through the CLI,
    11b knn_ivf at full width, 11c out of core, 11d over a mesh, 11e over
    two processes. Returns the kernel launches of its CLI runs summed."""
    totals: dict = {}

    def add(launches):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n

    launches, ivf_tsv = check_ivf_cli(fasta, os.path.join(out_dir, "a"),
                                      sim, card, dev, phase4_tsv)
    add(launches)
    b = check_ivf_search(dev, card)
    add(check_ivf_ooc(fasta, os.path.join(out_dir, "c"), sim, card, dev,
                      ivf_tsv, b, exact_ooc_secs))
    del b
    add(check_ivf_sharded(fasta, os.path.join(out_dir, "d"), sim, card, dev,
                          ivf_tsv))
    add(check_ivf_ranks(fasta, os.path.join(out_dir, "e"), sim, card, dev,
                        ivf_tsv, library_npz))
    return totals


def hold_k4(label: str, got, q, c, k: int, precision: str, first: int = 0,
            ids=None, run=None, chunk: int = 2048):
    """Hold K4's keys `got` (the merge of query rows q over candidate rows
    c, whose indices are first + j or ids[j], into the carry run) against
    merge_block_plain on the same inputs, on the card, query chunk by
    chunk: the plain width and unset slots, strictly descending keys,
    every score within K4_TOL of the plain product's score of its pair (a
    carry entry kept as it was), and each row's neighbor set the plain
    one's but where the plain k-th and (k+1)-th scores are within K4_TOL.
    Returns (the largest score error, the share of neighbors the plain
    version also has, the near-tie rows, the neighbors)."""
    import torch

    from fedrann_tpu_torch.knn.topk import (
        EMPTY_KEY,
        _decode_keys,
        merge_block_plain,
        round_rows,
    )

    m, n = q.shape[0], c.shape[0]
    width = min(k, (0 if run is None else run.shape[1]) + n)
    if tuple(got.shape) != (m, width):
        fail(f"{label}: K4 gave {tuple(got.shape)} keys, want {(m, width)}")
    cr = round_rows(c.float(), precision)
    if ids is not None:
        pos = torch.full((int(ids.max()) + 1,), -1, dtype=torch.int64,
                         device=c.device)
        pos[ids] = torch.arange(n, device=c.device)
    err, hit, total, ties = 0.0, 0, 0, 0
    for q0 in range(0, m, chunk):
        g, qc = got[q0 : q0 + chunk], q[q0 : q0 + chunk]
        carry = None if run is None else run[q0 : q0 + chunk]
        want = merge_block_plain(None if carry is None else carry.clone(),
                                 qc, c, first if ids is None else ids,
                                 width + 1, precision)
        empty = g == EMPTY_KEY
        if not torch.equal(empty, want[:, :width] == EMPTY_KEY):
            fail(f"{label}: K4's unset slots differ from the plain version's")
        if not bool(((g[:, 1:] < g[:, :-1]) | empty[:, 1:]).all()):
            fail(f"{label}: K4's keys are not strictly descending")
        gs, gi = _decode_keys(g)
        ws, wi = _decode_keys(want)
        if ids is None:
            col = gi - first
            mine = (col >= 0) & (col < n) & ~empty
        else:
            inside = (gi >= 0) & (gi < pos.shape[0])
            col = torch.where(inside, pos[gi.clamp(0, pos.shape[0] - 1)], -1)
            mine = (col >= 0) & ~empty
        pair = (round_rows(qc.float(), precision) @ cr.T).gather(
            1, col.clamp(0, n - 1))
        if bool(mine.any()):
            err = max(err, float((gs - pair).abs()[mine].max()))
        kept = ~mine & ~empty
        if bool(kept.any()) and not bool(
                (g[:, :, None] == carry[:, None, :]).any(-1)[kept].all()):
            fail(f"{label}: K4 kept a key that is neither a candidate's "
                 "nor the carry's")
        tie = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
        if want.shape[1] > width:
            tie = (want[:, width] != EMPTY_KEY) & (
                ws[:, width - 1] - ws[:, width] <= K4_TOL)
        gi = gi.masked_fill(empty, -1)
        wi = wi[:, :width].masked_fill(empty, -1)
        same = (torch.sort(gi, dim=1).values
                == torch.sort(wi, dim=1).values).all(dim=1)
        if not bool((same | tie).all()):
            r = int(torch.nonzero(~(same | tie))[0, 0]) + q0
            fail(f"{label}: row {r}'s neighbors differ from the plain "
                 "version's away from a near-tie")
        hit += int(((gi[:, :, None] == wi[:, None, :]).any(-1)
                    & ~empty).sum())
        total += int((~empty).sum())
        ties += int(tie.sum())
    if err > K4_TOL:
        fail(f"{label}: a K4 score is {err} from the plain one (tolerance "
             f"{K4_TOL})")
    return err, hit / max(total, 1), ties, total


def k4_edge_cases(dev):
    """K4's edge cases on the card: name -> (run, q, c, first, ids, k),
    unit rows from numpy (FLAGS' --seed), zero rows at query rows 0 and 5
    and candidate rows 7 and n - 1 (a zero query row ties at +0.0 on
    every candidate)."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn.topk import (
        EMPTY_KEY,
        merge_block_plain,
        normalize_rows,
    )

    rng = np.random.default_rng(int(FLAGS[FLAGS.index("--seed") + 1]))

    def rows(n, d):
        return normalize_rows(torch.from_numpy(rng.standard_normal(
            (n, d), dtype=np.float32)).to(dev))

    cases = {}
    for name, m, n, d, k in (("zero rows, ragged m and n", 1037, 3001, 512,
                              50),
                             ("m below a block, d = 40", 7, 513, 40, 16),
                             ("k past n", 200, 30, 64, 50),
                             ("k past a tile", 64, 2000, 32, 300),
                             ("ids form, carry with unset slots", 300, 777,
                              512, 50)):
        q, c = rows(m, d), rows(n, d)
        q[[0, 5 % m]] = 0
        c[[7, n - 1]] = 0
        run = ids = None
        if name.startswith("ids"):
            ids = torch.from_numpy(rng.permutation(10 * n)[:n]).to(dev)
            run = merge_block_plain(None, q, rows(100, d), 100_000, k)
            run[::2, k - 20 :] = EMPTY_KEY
        cases[name] = (run, q, c, 0 if ids is not None else 17, ids, k)
    return cases


def log_build(label: str, pattern: str, card: str) -> None:
    """Log what ptxas -v said of each kernel instance whose mangled name
    matches `pattern` (e.g. csrc/knn_merge.cu's K4 kernels) in the kernel
    library's build log: registers, spills, and static shared memory (the
    dynamic shared memory is set at launch)."""
    import re

    from fedrann_tpu_torch import _build

    path = str(_build.library_path()) + ".log"
    if not os.path.exists(path):
        fail(f"12: no build log at {path}")
    with open(path) as f:
        lines = f.read().splitlines()
    seen = {}
    for i, line in enumerate(lines):
        found = re.search(r"Function properties for (\S*(?:" + pattern
                          + r")\w*)", line)
        if found is None or found.group(1) in seen:
            continue
        text = " ".join(lines[i + 1 : i + 3])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", text)
        smem = re.search(r"(\d+) bytes smem", text)
        seen[found.group(1)] = (
            f"{regs.group(1) if regs else '?'} registers, spills "
            f"{spill.group(1) if spill else '?'}/"
            f"{spill.group(2) if spill else '?'} bytes, static smem "
            f"{smem.group(1) if smem else 0} bytes")
    if not seen:
        fail(f"12: the build log {path} names no {pattern} kernel")
    for name, text in seen.items():
        log(f"12 {label} build (ptxas -v) {name}: {text} [{card}]")


def check_knn_kernels(ckpt_dir: str, dev, card: str) -> dict:
    """Phase 12, K4 and K5 against their plain versions on the card: K4's
    build (log_build); K4 at phase 4's rows (4d's checkpoint; bf16,
    then the fp32 form; each also at K4_SPLITS forced units, bitwise the
    planned split's keys), at K4_ROWS and OOC_ROWS x 512 rank-16 rows
    (OOC_SAMPLE sampled queries over OOC_ROWS), and on k4_edge_cases at
    both precisions (hold_k4; zero query rows bitwise the plain keys),
    agreement >= K4_AGREE over every case; K5 at phase 4's library size
    (check_sign_table); K8 there (check_paired_table) and on its edge
    cases (k8_edge_cases). Logs each time with its TFLOP/s, units, bound and
    share, beside the bf16 product alone (torch.matmul, the yardstick),
    the plain version's and torch.topk on the keys. Returns K4's, K5's
    and K8's report entries at the main path's shapes."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.knn.topk import (
        _order_keys,
        merge_block,
        merge_block_plain,
        normalize_rows,
    )

    log_build("K4", "knn_merge", card)
    tally = []
    x = normalize_rows(torch.from_numpy(np.load(os.path.join(
        ckpt_dir, "embeddings.npy"))).to(dev))
    m, d = x.shape
    k = K4_K
    report = {}
    for precision, rows in (("bf16", x.to(torch.bfloat16)), ("fp32", x),
                            ("fp32", x.to(torch.bfloat16))):
        form = precision if rows.dtype == torch.float32 or precision == \
            "bf16" else "fp32 on bf16 rows"
        got = merge_block(None, rows, rows, 0, k, precision)
        units = merge_block.last_units
        err, agree, ties, total = hold_k4(
            f"12 phase 4's rows ({form})", got, rows, rows, k, precision)
        tally.append((agree, total))
        splits = []
        for forced in K4_SPLITS:
            other = merge_block(None, rows, rows, 0, k, precision,
                                units=forced)
            splits.append(merge_block.last_units)
            if not torch.equal(other, got):
                fail(f"12 phase 4's rows ({form}): K4 at {forced} "
                     f"forced units differs from the planned {units}")
        del other
        ms = time_cuda(lambda: merge_block(None, rows, rows, 0, k,
                                           precision), 10)
        plain_ms = time_cuda(lambda: merge_block_plain(
            None, rows, rows, 0, k, precision), 3)
        ops = 2 * m * m * d
        b = bound(2 * rows.numel() * rows.element_size() + m * k * 8,
                  **({"bf16_ops": ops} if precision == "bf16"
                     else {"fp32_ops": ops}))
        library_ms = time_cuda(lambda: torch.matmul(rows, rows.T), 10)
        keys = _order_keys(rows.float() @ rows.float().T, 0)
        topk_ms = time_cuda(lambda: torch.topk(keys, k, dim=1), 3)
        del keys
        log(f"12 K4 {form} at phase 4's rows ({m} x {d}, k = {k}), "
            f"{units} units: {ms:.4f} ms = {ops / ms / 1e9:.1f} TFLOP/s, "
            f"device "
            f"{device_us(lambda: merge_block(None, rows, rows, 0, k, precision), 5, True)} "
            f"us a launch; bound {b['bound_ms']:.5f} ms ({b['bound_by']}, "
            f"{100 * b['bound_ms'] / ms:.1f}% of it); torch.matmul of the "
            f"rows {library_ms:.4f} ms, torch.topk of the keys "
            f"{topk_ms:.4f} ms; plain {plain_ms:.4f} ms; forced units "
            f"{splits} bitwise the planned; scores within {err:.3g}, "
            f"agreement {agree:.6f}, {ties} near-tie rows [{card}]")
        if form in ("bf16", "fp32"):
            report["knn_merge" if form == "bf16" else "knn_merge_fp32"] = \
                dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, **b)
    del x

    emb, rng = rank16_rows(OOC_ROWS, 512)
    sample = np.sort(rng.choice(OOC_ROWS, OOC_SAMPLE, replace=False))
    for label, n, queries in ((f"{K4_ROWS} x 512", K4_ROWS, None),
                              (f"{OOC_ROWS} x 512, {OOC_SAMPLE} sampled "
                               "queries", OOC_ROWS, sample)):
        for precision in ("bf16", "fp32"):
            c = normalize_rows(torch.from_numpy(emb[:n]).to(dev))
            if precision == "bf16":
                c = c.to(torch.bfloat16)
            q = c if queries is None else c[torch.from_numpy(queries).to(dev)]
            got = merge_block(None, q, c, 0, K4_K, precision)
            units = merge_block.last_units
            err, agree, ties, total = hold_k4(f"12 {label} ({precision})",
                                              got, q, c, K4_K, precision)
            tally.append((agree, total))
            ms = time_cuda(lambda: merge_block(None, q, c, 0, K4_K,
                                               precision), 3)
            mm = time_cuda(lambda: torch.matmul(q, c.T), 3)
            ops = 2 * q.shape[0] * n * 512
            b = bound((q.shape[0] + n) * 512 * c.element_size()
                      + q.shape[0] * K4_K * 8,
                      **({"bf16_ops": ops} if precision == "bf16"
                         else {"fp32_ops": ops}))
            log(f"12 K4 {precision} at {label}, k = {K4_K}, {units} units: "
                f"{ms:.3f} ms = {ops / ms / 1e9:.1f} TFLOP/s; bound "
                f"{b['bound_ms']:.3f} ms ({b['bound_by']}, "
                f"{100 * b['bound_ms'] / ms:.1f}% of it); torch.matmul of "
                f"the rows {mm:.3f} ms; scores within {err:.3g}, agreement "
                f"{agree:.6f}, {ties} near-tie rows [{card}]")
            del c, q, got
    del emb

    for name, (run, q, c, first, ids, kk) in k4_edge_cases(dev).items():
        for precision in ("bf16", "fp32"):
            got = merge_block(None if run is None else run.clone(), q, c,
                              first if ids is None else ids, kk, precision)
            err, agree, ties, total = hold_k4(
                f"12 {name} ({precision})", got, q, c, kk, precision,
                first, ids, run)
            tally.append((agree, total))
            if run is None:
                want = merge_block_plain(None, q, c, first, kk, precision)
                if not torch.equal(got[[0, 5 % q.shape[0]]],
                                   want[[0, 5 % q.shape[0]]]):
                    fail(f"12 {name} ({precision}): a zero query row's keys "
                         "differ from the plain version's")
            log(f"12 K4 {name} ({precision}): {tuple(q.shape)} over "
                f"{tuple(c.shape)}, k = {kk}: scores within {err:.3g}, "
                f"agreement {agree:.6f}, {ties} near-tie rows")
    overall = (sum(a * t for a, t in tally) / max(sum(t for _, t in tally),
                                                  1))
    log(f"12 K4 agreement over every case {overall:.6f} (bar {K4_AGREE}) "
        f"[{card}]")
    if overall < K4_AGREE:
        fail(f"12: K4's agreement {overall:.6f} with the plain version "
             f"below {K4_AGREE}")

    config = config_from_args(["-i", "-", "-o", "-", *FLAGS])
    lib = np.load(os.path.join(ckpt_dir, "library.npz"))
    report["srp_signs"] = check_sign_table(
        "12 K5 at phase 4's library", len(lib["counts"]),
        config.embedding_dimension, config.projection_seed,
        config.projection_density, dev, card)
    report["srp_paired"] = check_paired_table(
        "12 K8 at phase 4's library", lib["counts"],
        config.embedding_dimension, config.projection_seed,
        config.projection_density, dev, card)
    k8_edge_cases(dev, card)
    return report


def ivf_case(en_pad, n_real: int, c: int, p: int, spill: int,
             k: int = IVF_K) -> dict:
    """knn_ivf's tables on the card for the rows en_pad[:n_real] (en_pad
    as knn/ivf.py _unit_padded makes it: a zero row last): the k-means,
    member table and probe tables of C = c, p probes and `spill`, and
    what K6 and rescore_plain take."""
    import torch

    from fedrann_tpu_torch.knn import ivf

    _, top = ivf._tables(en_pad[:n_real], c, 3, spill, p)
    member, counts_h = ivf._members(top[:, :spill].reshape(-1), c, spill)
    case = table_case(en_pad, n_real, member, counts_h,
                      top[:, :p].contiguous(), 0, k)
    # K11's member side, as knn_ivf makes it
    case["members"] = ivf._member_side(top[:, :spill].reshape(-1), c, spill)
    return case


def table_case(en_pad, n_real: int, member, counts_h, probes, first: int,
               k: int) -> dict:
    """One rescore's inputs on the card: the dense tables and JAX's plan
    (rescore_plain's), and the member and probe buckets with K6's work
    list from K11 (rescore_clusters'), the member side from the dense
    table (k6_edge_case and k6_flood_case make theirs by hand)."""
    from fedrann_tpu_torch.knn import ivf

    c, p = member.shape[0], probes.shape[1]
    qtab, stab, qcounts_h = ivf._queries(probes, c)
    members = ivf.table_buckets(member, counts_h)
    return dict(en_pad=en_pad, n_real=n_real, member=member,
                counts_h=counts_h, qtab=qtab, stab=stab,
                qcounts_h=qcounts_h, first=first, nq=probes.shape[0], p=p,
                k=k, kk_g=min(k, member.shape[1]), groups=ivf._rescore_plan(
                    counts_h, qcounts_h, qtab.shape[1], member.shape[1]),
                real=int((qcounts_h.astype("int64")
                          * counts_h.astype("int64")).sum()),
                members=members, queries=ivf.bucket_clusters(
                    probes.reshape(-1).contiguous(), c, p, members.bounds))


def k6_run(case: dict, precision: str, queries=None):
    from fedrann_tpu_torch.knn.ivf import rescore_clusters

    return rescore_clusters(
        case["en_pad"], case["n_real"], case["members"],
        case["queries"] if queries is None else queries, case["first"],
        case["nq"], case["p"], case["kk_g"], precision)


def pr16_ms(name: str, at: str) -> str:
    """PR 16's time of kernel `name` at shape `at` (PR16_MS), or "not
    timed" at a shape it was not timed at."""
    ms = PR16_MS.get((name, at))
    return "not timed" if ms is None else f"{ms} ms"


def padded_k6(case: dict, precision: str):
    """A check to call after one K6 launch on `case` at `precision`: it
    fails unless the launch took a padded copy of the rows exactly where d
    * itemsize is no multiple of 16 (rescore_clusters.padded_launches)."""
    from fedrann_tpu_torch.knn.ivf import rescore_clusters
    from fedrann_tpu_torch.knn.topk import tma_width

    d = case["en_pad"].shape[1]
    pitch = tma_width(d, 2 if precision == "bf16" else 4)
    before = rescore_clusters.padded_launches

    def check():
        got = rescore_clusters.padded_launches - before
        if got != int(pitch != d):
            fail(f"K6 at d = {d} ({precision}): {got} launches on a padded "
                 f"copy, where its pitch is {pitch}")

    return check


def k6_plain(case: dict):
    from fedrann_tpu_torch.knn.ivf import rescore_plain

    return rescore_plain(case["en_pad"], case["n_real"], case["member"],
                         case["qtab"], case["stab"], case["groups"],
                         case["first"], case["nq"], case["p"], case["k"],
                         case["kk_g"])


def hold_k6(label: str, got, want, chunk: int = 16384) -> tuple:
    """K6's buffer `got` against rescore_plain's `want`: the same
    EMPTY_KEY slots, every list strictly descending, and over the lists
    the share of K6's entries whose index the plain list also holds (>=
    K6_AGREE) and the largest score difference of such a pair (<=
    K6_TOL). Returns (agreement, largest difference)."""
    import torch

    from fedrann_tpu_torch.knn.topk import EMPTY_KEY, _decode_keys

    w_ = got.shape[-1]
    g_all, w_all = got.reshape(-1, w_), want.reshape(-1, w_)
    if tuple(got.shape) != tuple(want.shape) or not torch.equal(
            g_all == EMPTY_KEY, w_all == EMPTY_KEY):
        fail(f"{label}: K6's buffer {tuple(got.shape)} or its unset slots "
             "differ from the plain version's")
    hit, total, err = 0, 0, 0.0
    for r0 in range(0, g_all.shape[0], chunk):
        g, w = g_all[r0 : r0 + chunk], w_all[r0 : r0 + chunk]
        ge = g == EMPTY_KEY
        if not bool(((g[:, 1:] < g[:, :-1]) | ge[:, 1:]).all()):
            fail(f"{label}: a K6 list is not strictly descending")
        gs, gi = _decode_keys(g)
        ws, wi = _decode_keys(w)
        eq = ((gi[:, :, None] == wi[:, None, :]) & ~ge[:, :, None]
              & ~ge[:, None, :])
        hit += int(eq.any(2).sum())
        total += int((~ge).sum())
        if bool(eq.any()):
            err = max(err, float((gs[:, :, None] - ws[:, None, :]).abs()
                                 [eq].max()))
        del eq
    agree = hit / max(total, 1)
    if agree < K6_AGREE or err > K6_TOL:
        fail(f"{label}: K6 agrees {agree:.6f} with the plain lists (bar "
             f"{K6_AGREE}), scores within {err:.3g} (tolerance {K6_TOL})")
    return agree, err


def grid_rows(rng, n: int, d: int, dev):
    """(n, d) float32 rows of entries k / 64, |k| <= 8: exact in bfloat16,
    and every product and partial sum of d = 512 of them exact in
    float32 (multiples of 2^-12 below 8 in magnitude)."""
    import torch

    return torch.from_numpy(rng.integers(-8, 9, size=(n, d)).astype(
        "float32") / 64).to(dev)


def k6_edge_case(dev, k: int = 50) -> dict:
    """K6's edge cases in one table, on grid rows (FLAGS' --seed): C = 8
    clusters of 1, 300 (past a tile and the first selection's 256), 20 (k
    = 50 past its members), 60 (ten of them sentinel rows >= n_real, whose
    rows would win), 100 (never probed), 0 (probed), 129 and 200 members,
    clusters sharing rows (a spill); 300 query rows from row 100 (a row
    offset), 3 probes each among the probed clusters; k neighbors."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn import ivf

    rng = np.random.default_rng(int(FLAGS[FLAGS.index("--seed") + 1]) + 16)
    n_real, extra, d = 900, 40, 512
    rows = grid_rows(rng, n_real + extra, d, dev)
    rows[n_real:] = 8 / 64  # sentinel rows: the best scores if offered
    en_pad = torch.cat([rows, rows.new_zeros((1, d))])
    sizes = [1, 300, 20, 60, 100, 0, 129, 200]
    member = np.full((8, ivf._ceil128(max(sizes))), n_real, np.int32)
    for c, m in enumerate(sizes):
        member[c, :m] = rng.choice(n_real, m, replace=False)
    member[3, ::6][:10] = n_real + np.arange(10)
    probed = [0, 1, 2, 3, 5, 6, 7]
    nq, p, first = 300, 3, 100
    probes = torch.from_numpy(np.stack([rng.choice(probed, p, replace=False)
                                        for _ in range(nq)]).astype(
        np.int32)).to(dev)
    return table_case(en_pad, n_real, torch.from_numpy(member).to(dev),
                      np.array(sizes, np.int64), probes, first, k)


def k6_flood_case(dev, k: int) -> dict:
    """A cluster whose members score higher tile by tile for every query,
    so K6's rows overflow their survivor slots: 700 members, member i's
    first level(i) of 64 values 8 / 64 and the rest -8 / 64, 130 queries of
    all 1 / 64 (score (2 level - 64) / 512); levels i // 8 over the first
    256 members, then 40 at 32 and 88 at 0, then 128 at 33 (every key of
    the tile beats every earlier one), then 34 + (i - 512) // 40; ties to
    the lowest index. A second cluster of 90 grid rows (FLAGS' --seed), 10
    of them sentinel rows >= n_real; every query probes both."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn import ivf

    rng = np.random.default_rng(int(FLAGS[FLAGS.index("--seed") + 1]) + 41)
    n_real, d = 1000, 64
    level = np.concatenate([np.arange(256) // 8, np.full(40, 32),
                            np.zeros(88, np.int64), np.full(128, 33),
                            34 + np.arange(188) // 40])
    rows = np.full((n_real + 20, d), -8 / 64, np.float32)
    for i, lv in enumerate(level):
        rows[i, :lv] = 8 / 64
    rows[700:830] = 1 / 64
    rows[830:n_real] = rng.integers(-8, 9, (n_real - 830, d)) / 64
    rows[n_real:] = 8 / 64
    en_pad = torch.cat([torch.from_numpy(rows), torch.zeros((1, d))]).to(dev)
    member = np.full((2, 768), n_real, np.int32)
    member[0, :700] = np.arange(700)
    member[1, :90] = 830 + np.arange(90)
    member[1, ::9][:10] = n_real + np.arange(10)
    probes = torch.from_numpy(np.tile(np.array([[0, 1]], np.int32),
                                      (130, 1))).to(dev)
    return table_case(en_pad, n_real, torch.from_numpy(member).to(dev),
                      np.array([700, 90], np.int64), probes, 700, k)


def sorted_lists(rng, rows: int, p: int, w: int, dev):
    """(rows, p, w) int64 keys, each list sorted descending: random
    scores on indices drawn from 3 w values, so an index recurs across a
    row's lists with other scores, EMPTY_KEY tails of random length, and
    rows with no key at all."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn.topk import EMPTY_KEY, _order_keys

    s = torch.from_numpy(rng.standard_normal((rows, p, w)).astype(
        np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 3 * w, (rows, p, w))).to(dev)
    keys = _order_keys(s, idx)
    keys.masked_fill_(torch.from_numpy(
        np.arange(w)[None, None, :] >= rng.integers(0, w + 1, (rows, p, 1))
    ).to(dev), EMPTY_KEY)
    keys[: max(1, rows // 50)] = EMPTY_KEY
    return torch.sort(keys, dim=2, descending=True).values.contiguous()


def check_ivf_kernels(ckpt_dir: str, dev, card: str) -> dict:
    """Phase 12, the IVF search's kernels against their plain versions on
    the card. K6 (csrc/ivf_rescore.cu) bitwise rescore_plain on grid rows
    (grid_rows: every score exact) at both precisions, at k6_edge_case
    and at phase 4's size with d = 512, CLI_D and 130 (the last two on a
    copy padded to a 16-byte pitch where d * itemsize needs it, counted
    in .padded_launches); on real rows (phase 4's rows at C = 256, 11b's
    262,144 read-overlap rows, and those cut to CLI_D columns, spill 2)
    to hold_k6's bars; two launches byte-identical. K7 bitwise
    merge_buffers_plain on K6's own buffers at spill 1, 2 and 3 and on
    sorted_lists. K4 as the IVF's
    cluster ranking (_top_clusters) against top_clusters_plain: agreement
    >= K6_AGREE at t = 1 and t = 8, ties to the lowest id on duplicated
    centroids. K9 bitwise segment_sum_plain on k9_edge_cases and on the
    real rows with their own k-means's assignments (check_segment_sums).
    Each timed beside its plain version (and K7 beside torch.topk of the
    buffer rows at spill 1, K9 beside index_add_), with its bound: K6 2 d
    operations a real pair-score (bf16 or FFMA) or the bytes of its
    query gathers and the buffer, K7 the buffer's bytes and the result's,
    K9 the rows', ids' and sums' bytes. K10 (the result wire) and K11
    (the member and probe tables) on the same real rows: check_wire and
    check_tables, and k11_edge_cases. Returns K6's (both forms), K7's,
    K9's, K10's and K11's report entries at phase 4's rows with C = 256,
    the IVF main path's shapes (K10 on the u16 wire, the main path's)."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn import ivf

    rng_seed = int(FLAGS[FLAGS.index("--seed") + 1])
    rng = np.random.default_rng(rng_seed)
    report = {}

    def merges(label, buf, k, spill):
        got = ivf.merge_probe_lists(buf, k, spill)
        if not torch.equal(got, ivf.merge_buffers_plain(buf, k, spill)):
            fail(f"{label}: K7 at spill {spill} differs from "
                 "merge_buffers_plain")
        return got

    log_build("K6/K7", "ivf_(?:rescore|merge)", card)
    log_build("K10/K11", "keys_to_host|bucket_kernel", card)
    # grid rows: bitwise
    cases = [("12 K6 edge cases", k6_edge_case(dev)),
             ("12 K6 grid rows, 15,000 x 512, C = 256",
              ivf_case(torch.cat([grid_rows(rng, 15000, 512, dev),
                                  torch.zeros((1, 512), device=dev)]),
                       15000, 256, 8, 2))]
    cases += [(f"12 K6 edge cases, W = {k}", k6_edge_case(dev, k))
              for k in (1, 64, 100)]
    cases += [(f"12 K6 a 700-member cluster overflowing its survivors, W = "
               f"{k}", k6_flood_case(dev, k)) for k in (1, 50, 64, 100)]
    # the CLI's width (1,000 bytes a bf16 row) and one of no 4 entries
    cases += [(f"12 K6 grid rows, 15,000 x {d}, C = 256",
               ivf_case(torch.cat([grid_rows(np.random.default_rng(
                   rng_seed + d), 15000, d, dev),
                   torch.zeros((1, d), device=dev)]), 15000, 256, 8, 2))
              for d in (CLI_D, 130)]
    for label, case in cases:
        want = k6_plain(case)
        for precision in ("bf16", "fp32"):
            padded = padded_k6(case, precision)
            got = k6_run(case, precision)
            padded()
            if not torch.equal(got, want):
                bad = (got != want).reshape(-1, case["kk_g"]).any(1)
                fail(f"{label} ({precision}): K6 differs from rescore_plain "
                     f"in {int(bad.sum())} of {bad.numel()} lists")
            if not torch.equal(got, k6_run(case, precision, ivf.host_units(
                    case["members"], case["queries"]))):
                fail(f"{label} ({precision}): K6 on K11's work list differs "
                     "from K6 on the host's (host_units)")
        for spill in (1, 2, 3):
            merges(f"{label}", want, case["k"], spill)
        log(f"{label} (largest cluster {int(case['counts_h'].max())}): K6 "
            "bf16 and fp32 bitwise rescore_plain, on K11's work list and on "
            f"the host's ({case['real']} real pair-scores), K7 bitwise "
            f"at spill 1, 2, 3 [{card}]")

    # K7 on sorted lists with recurring indices of other scores
    for rows, p, w, k in ((3000, 8, 50, 50), (500, 3, 7, 10),
                          (200, 40, 20, 300), (100, 1, 64, 64),
                          (50, 40, 20, 600)):
        buf = sorted_lists(rng, rows, p, w, dev)
        for spill in (1, 2, 3):
            merges(f"12 K7 sorted lists ({rows}, {p}, {w}), k = {k}", buf, k,
                   spill)
    log("12 K7 bitwise merge_buffers_plain on sorted lists with recurring "
        "indices (p = 8, 3, 40, 1, 40; k past p w and past the network's "
        "512; with dedup their rows take the exact finish) at spill 1, 2 "
        "and 3")

    # K4 as the cluster ranking, with two centroids equal
    x = torch.from_numpy(np.load(os.path.join(ckpt_dir, "embeddings.npy"))
                         ).to(dev)
    en_pad = ivf._unit_padded(x, "bf16")
    n4 = x.shape[0]
    cent = ivf._kmeans(en_pad[:n4], 256, 3)
    cent[77] = cent[12]
    for t in (1, 8):
        got = ivf._top_clusters(en_pad[:n4], cent, t)
        want = ivf.top_clusters_plain(en_pad[:n4], cent, t)
        agree = set_agreement(got.cpu().numpy(), want.cpu().numpy())
        g = got.cpu().numpy()
        if (g == 77).any(axis=1)[~(g == 12).any(axis=1)].any() or \
                (np.argmax(g == 77, axis=1) < np.argmax(g == 12, axis=1))[
                    (g == 77).any(axis=1)].any():
            fail(f"12 K4 cluster ranking t = {t}: the duplicated centroid's "
                 "higher id came before (or without) its lower")
        ms = time_cuda(lambda: ivf._top_clusters(en_pad[:n4], cent, t), 5)
        plain_ms = time_cuda(lambda: ivf.top_clusters_plain(
            en_pad[:n4], cent, t), 3)
        log(f"12 K4 as the IVF cluster ranking, phase 4's rows over 256 "
            f"centroids, t = {t}: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
            f"agreement {agree:.6f}, ties to the lower of two equal "
            f"centroids [{card}]")
        if agree < K6_AGREE:
            fail(f"12 K4 cluster ranking t = {t}: agreement {agree:.6f} "
                 f"below {K6_AGREE}")
    del en_pad

    k9_edge_cases(dev, card)
    k11_edge_cases(dev, card)
    # real rows: phase 4's at C = 256 (the report), 11b's, and 11b's cut to
    # the CLI's width (K6 and K7 alone: a padded copy of the rows in bf16)
    big = overlap_rows(IVF_ROWS, dev)
    for at, label, rows, c in (
            ("phase 4", "phase 4's rows, C = 256", x, 256),
            ("11b", f"11b's {IVF_ROWS} x 512 rows, C = 1,024", big, 1024),
            ("11b cut", f"11b's rows cut to {IVF_ROWS} x {CLI_D} (the "
             "CLI's width), C = 1,024", big[:, :CLI_D], 1024)):
        d = rows.shape[1]
        if at != "11b cut":
            seg = check_segment_sums(f"12 K9 at {label}", ivf._unit_padded(
                rows, "bf16")[: rows.shape[0]], c, card)
            if c == 256:
                report["ivf_segment_sum"] = seg
            en = ivf._unit_padded(rows, "bf16")[: rows.shape[0]]
            wire = check_wire(f"12 K10 at {label}", en, card)
            tables = check_tables(f"12 K11 at {label}", en, c, card)
            if c == 256:
                report.update(result_wire=wire, ivf_buckets=tables)
            del en
        for precision in ("bf16", "fp32"):
            case = ivf_case(ivf._unit_padded(rows, precision),
                            rows.shape[0], c, 8, 2)
            padded = padded_k6(case, precision)
            got = k6_run(case, precision)
            padded()
            if not torch.equal(got, k6_run(case, precision)):
                fail(f"12 K6 {label} ({precision}): two launches differ")
            if not torch.equal(got, k6_run(case, precision, ivf.host_units(
                    case["members"], case["queries"]))):
                fail(f"12 K6 {label} ({precision}): K6 on K11's work list "
                     "differs from K6 on the host's (host_units)")
            want = k6_plain(case)
            agree, err = hold_k6(f"12 K6 {label} ({precision})", got, want)
            merged = merges(f"12 K7 {label} ({precision})", got, IVF_K, 2)
            del want
            ms = time_cuda(lambda: k6_run(case, precision), 5)
            plain_ms = time_cuda(lambda: k6_plain(case), 1)
            itemsize = 2 if precision == "bf16" else 4
            ops = 2 * d * case["real"]
            b = bound(case["nq"] * case["p"] * d * itemsize + got.numel()
                      * 8, **({"bf16_ops": ops} if precision == "bf16"
                              else {"fp32_ops": ops}))
            units = int(case["queries"].n_units[0])
            name = "ivf_rescore" if precision == "bf16" else \
                "ivf_rescore_fp32"
            probed = sum(len(v) for v in case["groups"].values())
            log(f"12 K6 {precision} at {label}: {case['real']} real pair-"
                f"scores ({probed} probed clusters, {units} units, largest "
                f"cluster "
                f"{int(case['counts_h'].max())}): {ms:.4f} ms = "
                f"{ops / ms / 1e9:.1f} TFLOP/s, device "
                f"{device_us(lambda: k6_run(case, precision), 3, True)} us a "
                f"launch; bound {b['bound_ms']:.5f} ms ({b['bound_by']}, "
                f"{100 * b['bound_ms'] / ms:.1f}% of it); plain "
                f"{plain_ms:.4f} ms; PR 16's design "
                f"{pr16_ms(name, at)}; agreement {agree:.6f}, scores "
                f"within {err:.3g}; two launches byte-identical, and "
                f"bitwise on the host's work list [{card}]")
            flat = got.reshape(case["nq"], -1)
            kk = merged.shape[1]
            k7_ms = time_cuda(lambda: ivf.merge_probe_lists(got, IVF_K, 2), 5)
            k7_1 = time_cuda(lambda: ivf.merge_probe_lists(got, IVF_K, 1), 5)
            k7_plain = time_cuda(lambda: ivf.merge_buffers_plain(
                got, IVF_K, 2), 1)
            topk_ms = time_cuda(lambda: torch.topk(flat, kk, dim=1), 5)
            b7 = bound(got.numel() * 8 + merged.numel() * 8)
            log(f"12 K7 at {label} ({precision} buffer {tuple(got.shape)}): "
                f"spill 2 {k7_ms:.4f} ms, spill 1 {k7_1:.4f} ms, device "
                f"{device_us(lambda: ivf.merge_probe_lists(got, IVF_K, 2), 3, True)}"
                f" us a launch; bound {b7['bound_ms']:.5f} ms (bytes, "
                f"{100 * b7['bound_ms'] / k7_ms:.1f}% of it); plain "
                f"{k7_plain:.4f} ms; torch.topk of the buffer rows "
                f"{topk_ms:.4f} ms; PR 16's design "
                f"{pr16_ms('ivf_merge', at)}; bitwise the plain merge "
                f"[{card}]")
            if c == 256:
                report[name] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=None, **b)
                if precision == "bf16":
                    report["ivf_merge"] = dict(
                        max_abs_err=0.0, ms=k7_ms, plain_ms=k7_plain,
                        library_ms=topk_ms, **b7)
            del got, merged, flat, case
    return report


def hold_k9(label: str, rows, a, c: int):
    """K9 (ivf._segment_sum on the card) against segment_sum_plain on
    rows and assignments a, bitwise (int32 views), and two launches
    byte-identical; fails otherwise. Returns K9's sums."""
    import torch

    from fedrann_tpu_torch.knn import ivf

    got = ivf._segment_sum(rows, a, c)
    again = ivf._segment_sum(rows, a, c)
    if not torch.equal(got.view(torch.int32),
                       ivf.segment_sum_plain(rows, a, c).view(torch.int32)):
        fail(f"{label}: K9 differs from segment_sum_plain")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        fail(f"{label}: two K9 launches differ")
    return got


def k9_edge_cases(dev, card: str) -> None:
    """K9 bitwise segment_sum_plain on the card, float32 and bfloat16
    rows, two launches byte-identical: empty clusters (every odd one),
    one cluster holding every row, a one-row cluster, N = 1, C = 8, d =
    100 (a unit of 100 columns), zero rows, N = 0, and C = 65,536 over
    the 5,000 rows (its counts in device memory), where its bucketing
    must also equal _segments'."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((5000, 512)).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, 64, 5000).astype(np.int32))
    single = torch.where(a == 3, 4, a)
    single[2500] = 3
    zero = x.clone()
    zero[::3] = 0.0
    cases = [("empty clusters", x, a - a % 2, 64),
             ("one cluster holding every row", x, torch.zeros_like(a), 16),
             ("a one-row cluster", x, single, 64),
             ("N = 1", x[:1], a[:1], 64), ("C = 8", x, a % 8, 8),
             ("d = 100", x[:, :100].contiguous(), a, 64),
             ("zero rows", zero, a, 64), ("N = 0", x[:0], a[:0], 8),
             ("C = 65,536", x, torch.from_numpy(rng.integers(
                 0, 65_536, 5000).astype(np.int32)), 65_536)]
    from fedrann_tpu_torch.knn import ivf

    wide = cases[-1][2].to(dev)
    order, bounds = ivf.segment_buckets(wide, 65_536)
    want_order, want_bounds = ivf._segments(wide, 65_536)
    if not (torch.equal(order.long(), want_order)
            and torch.equal(bounds.long(), want_bounds)):
        fail("12 K9 edge case C = 65,536: its bucketing differs from "
             "_segments'")
    for label, rows, assign, c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            hold_k9(f"12 K9 edge case {label} ({dtype})",
                    rows.to(dev, dtype), assign.to(dev), c)
    log("12 K9 bitwise segment_sum_plain, two launches byte-identical, on "
        "float32 and bfloat16 rows at " + ", ".join(c[0] for c in cases)
        + f" [{card}]")


def check_segment_sums(label: str, en, c: int, card: str) -> dict:
    """K9 on the unit rows en (N, d) float32 at C = c with the
    assignments of their own k-means (ivf._kmeans, then _top_clusters):
    its bucketing (segment_buckets) equal to _segments' (order, bounds);
    bitwise segment_sum_plain and two launches byte-identical (hold_k9)
    on float32 rows and on bfloat16 rows (the out-of-core wire); each
    whole call timed (the bucketing included; the median of 7 timings, as
    index_add_'s), with the device us of each of its kernels (the sum
    kernel alone among them), the plain version and index_add_ (the same
    sums in the order its atomics land; of the widened rows for
    bfloat16; with its device us, as K9's call is bound by its host path
    where the rows are few), beside the earlier design's call
    (EARLIER_MS), with its
    bound: the rows and the N int32 assignments read once, the sums
    written (the earlier bound, with its sorted int64 ids and bounds,
    logged beside). Returns the float32 rows' report entry."""
    import torch

    from fedrann_tpu_torch.knn import ivf

    n, d = en.shape
    a = ivf._top_clusters(en, ivf._kmeans(en, c, 3), 1)[:, 0]
    sizes = torch.bincount(a, minlength=c)
    order, bounds = ivf.segment_buckets(a, c)
    want_order, want_bounds = ivf._segments(a, c)
    if not (torch.equal(order.long(), want_order)
            and torch.equal(bounds.long(), want_bounds)):
        fail(f"{label}: K9's bucketing differs from _segments")
    bucket_ms = time_cuda(lambda: ivf.segment_buckets(a, c), 10)
    sort_ms = time_cuda(lambda: ivf._segments(a, c), 10)
    log(f"{label}: K9's bucketing equals _segments' (order, bounds); "
        f"{bucket_ms:.4f} ms alone, device "
        f"{device_us(lambda: ivf.segment_buckets(a, c), 5, True)} us a "
        f"call; _segments' torch sort and searchsorted {sort_ms:.4f} ms "
        f"[{card}]")
    del order, bounds, want_order, want_bounds
    at = "phase 4" if c == 256 else "11b"
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = en.to(dtype).contiguous()
        got = hold_k9(f"{label} ({dtype})", rows, a, c)

        def k9():
            return ivf._segment_sum(rows, a, c)

        def index_add():
            return torch.zeros((c, d), device=rows.device).index_add_(
                0, a, rows.float())

        err = float((got - index_add()).abs().max())
        # at phase 4's rows both take ~0.02-0.05 ms and K9's call is bound
        # by its host path, so the host's jitter moves one timing: the
        # median of 7 timings of 20 calls each, with their range logged
        ms, ms_range = time_cuda_median(k9, 20, 7)
        plain_ms = time_cuda(lambda: ivf.segment_sum_plain(rows, a, c), 1)
        lib_ms, lib_range = time_cuda_median(index_add, 20, 7)
        b = bound(rows.numel() * rows.element_size() + n * 4 + c * d * 4)
        old = bound(rows.numel() * rows.element_size() + n * 8
                    + (c + 1) * 8 + c * d * 4)
        was = EARLIER_MS[("ivf_segment_sum", at, str(dtype)[6:])]
        log(f"{label} ({dtype} rows, largest cluster {int(sizes.max())}, "
            f"{int((sizes == 0).sum())} empty): {ms:.4f} ms the whole call "
            f"(median; {ms_range[0]:.4f}-{ms_range[1]:.4f}) [earlier "
            f"{was:.4f}], device {device_us(k9, 5, True)} us a call; "
            f"bound {b['bound_ms']:.5f} ms (bytes, "
            f"{100 * b['bound_ms'] / ms:.1f}% "
            f"of it; the earlier bound {old['bound_ms']:.5f}); plain "
            f"{plain_ms:.4f} ms; index_add_ {lib_ms:.4f} ms (median; "
            f"{lib_range[0]:.4f}-{lib_range[1]:.4f}; "
            f"{'above' if lib_ms > ms else 'below'} the call; device "
            f"{device_us(index_add, 5, False)} us a call), within "
            f"{err:.3g} of K9; bitwise the plain sums, two launches "
            f"byte-identical [{card}]")
        report[dtype] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, **b)
        del got, rows
    return report[torch.float32]


def wire_edge_keys(dev):
    """(4, 8) int64 keys on `dev` of the wire's edge scores (-0.0, 0.0,
    1.0, -1.0, a bf16 overshoot just past 1 and just below -1) and of
    scores whose u16 grid position is an exact half above an even step
    (round half to even goes down there), two slots EMPTY_KEY."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn.topk import EMPTY_KEY, _order_keys

    s = np.random.default_rng(20).uniform(-1.0, 1.0, 400_000).astype(
        np.float32)
    t = (np.float32(1.0) - s) * np.float32(32767.5)
    half = s[(t - np.floor(t) == np.float32(0.5)) & (np.floor(t) % 2 == 0)]
    edges = np.array([-0.0, 0.0, 1.0, -1.0,
                      np.nextafter(np.float32(1), np.float32(2)),
                      np.nextafter(np.float32(-1), np.float32(-2))],
                     np.float32)
    scores = np.concatenate([edges, half[:26]]).reshape(4, 8)
    keys = _order_keys(torch.from_numpy(scores), torch.arange(
        32, dtype=torch.int64).view(4, 8)).to(dev)
    keys[1, 3] = keys[3, 7] = EMPTY_KEY
    return keys


def hold_wire(label: str, got, want) -> None:
    """K10's (indices, distances) byte-identical to keys_to_host_plain's;
    fails otherwise."""
    import numpy as np

    if not (got[0].dtype == want[0].dtype == np.int32
            and got[1].dtype == want[1].dtype == np.float32
            and np.array_equal(got[0], want[0])
            and np.array_equal(got[1].view(np.int32),
                               want[1].view(np.int32))):
        fail(f"{label}: K10 differs from keys_to_host_plain")


def host_link() -> str:
    """The card's host link as nvidia-smi reports it: its generation and
    width now and at most."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.gpucurrent,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode or not smi.stdout.strip():
        return f"not read ({smi.stderr.strip() or smi.stdout.strip()})"
    gen, width, gen_max, width_max = (
        v.strip() for v in smi.stdout.strip().splitlines()[0].split(","))
    return (f"PCIe Gen{gen} x{width} now, Gen{gen_max} x{width_max} at "
            "most")


def check_wire(label: str, en, card: str) -> dict:
    """K10 (keys_to_host on CUDA keys) against keys_to_host_plain on the
    card, byte-identical: the k-NN keys of the unit rows en (N, d) (K4,
    k = IVF_K, bf16) on the u16 wire (uint16 indices where N <= 65,536)
    and the f32 wire, as they are and with a tenth of the slots and one
    row EMPTY_KEY, at rows = 0 and k = 1, and the wire's edge scores
    (wire_edge_keys); two results held at once stay intact; a result
    written into a page-locked block of its own (topk.HostBlock: set
    topk.PIN_CACHE_BYTES to 0 for the check) is byte-identical too, its
    block freed with it, and timed. Each wire
    timed (host-synchronous calls) beside the plain version, its device
    us, and a pinned non_blocking copy_ of the result's 8 bytes an entry
    from device memory (a floor, not a call that computes the decode);
    the bound is the larger of the keys' bytes over PEAK_BYTES and the
    result's bytes over the host link's nominal rate (PEAK_HOST_LINK).
    Returns the u16 wire's report entry (phase 4's main path runs
    --knn-transfer u16)."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn import topk
    from fedrann_tpu_torch.knn.topk import (
        EMPTY_KEY,
        keys_to_host,
        keys_to_host_plain,
        merge_block,
    )

    n = en.shape[0]
    q = en.to(torch.bfloat16).contiguous()
    keys = merge_block(None, q, q, 0, IVF_K, "bf16")
    del q
    holes = keys.clone()
    mask = torch.from_numpy(np.random.default_rng(n).random(
        tuple(keys.shape)) < 0.1).to(keys.device)
    holes[mask] = EMPTY_KEY
    holes[7] = EMPTY_KEY
    edges = wire_edge_keys(keys.device)
    cases = (("", keys), (" with EMPTY_KEY slots", holes),
             (" at rows = 0", keys[:0]),
             (" at k = 1", keys[:, :1].contiguous()))
    link = host_link()
    report = {}
    for transfer in ("u16", "f32"):
        for what, kk in cases:
            hold_wire(f"{label}{what} ({transfer})",
                      keys_to_host(kk, transfer, n),
                      keys_to_host_plain(kk, transfer, n))
        hold_wire(f"{label} edge scores ({transfer})",
                  keys_to_host(edges, transfer, 100),
                  keys_to_host_plain(edges, transfer, 100))
        first = keys_to_host(keys, transfer, n)
        second = keys_to_host(holes, transfer, n)
        hold_wire(f"{label}: the first of two results held ({transfer})",
                  first, keys_to_host_plain(keys, transfer, n))
        hold_wire(f"{label}: the second of two results held ({transfer})",
                  second, keys_to_host_plain(holes, transfer, n))
        del first, second
        cached, live = topk.PIN_CACHE_BYTES, topk.HostBlock.live
        topk.PIN_CACHE_BYTES = 0
        try:
            hold_wire(f"{label} in a block of its own ({transfer})",
                      keys_to_host(holes, transfer, n),
                      keys_to_host_plain(holes, transfer, n))
            own_ms = time_cuda(lambda: keys_to_host(keys, transfer, n), 3)
        finally:
            topk.PIN_CACHE_BYTES = cached
        if topk.HostBlock.live != live:
            fail(f"{label}: {topk.HostBlock.live - live} page-locked blocks "
                 "of their own outlived their results")
        ms = time_cuda(lambda: keys_to_host(keys, transfer, n), 10)
        plain_ms = time_cuda(lambda: keys_to_host_plain(keys, transfer, n),
                             3)
        src = torch.empty((2, *keys.shape), dtype=torch.int32,
                          device=keys.device)
        dst = torch.empty((2, *keys.shape), dtype=torch.int32,
                          pin_memory=True)
        copy_ms = time_cuda(lambda: dst.copy_(src, non_blocking=True), 10)
        del src, dst
        out_bytes = keys.numel() * 8
        link_ms = out_bytes / PEAK_HOST_LINK * 1e3
        b = bound(keys.numel() * 8)
        b["bound_ms"] = max(b["bound_ms"], link_ms)
        u16_idx = transfer == "u16" and n <= 65536
        log(f"{label}, {transfer} wire ({'uint16' if u16_idx else 'int32'}"
            f" indices, {tuple(keys.shape)} keys): {ms:.4f} ms a call, "
            f"device {device_us(lambda: keys_to_host(keys, transfer, n), 5, True)}"
            f" us a launch; plain {plain_ms:.4f} ms; a pinned non_blocking "
            f"copy_ of its {out_bytes} result bytes {copy_ms:.4f} ms "
            f"({out_bytes / copy_ms / 1e6:.1f} GB/s; the floor, no call "
            f"computes the decode); bound {b['bound_ms']:.5f} ms (bytes: "
            f"the result over the host link's nominal "
            f"{PEAK_HOST_LINK / 1e9:.1f} GB/s, {link_ms:.5f}; the keys' read "
            f"{keys.numel() * 8 / PEAK_BYTES * 1e3:.5f}; "
            f"{100 * b['bound_ms'] / ms:.1f}% of it; the copy_ reads "
            f"{100 * link_ms / copy_ms:.1f}% of the link); into a page-locked "
            f"block of its own (past PIN_CACHE_BYTES) {own_ms:.4f} ms a call;"
            f" host link {link}; byte-identical to the plain version as it "
            f"is, with EMPTY_KEY slots, at rows = 0, k = 1 and the edge "
            f"scores, two results held intact, in a block of its own, freed "
            f"with it [{card}]")
        report[transfer] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                library_ms=None, **b)
    return report["u16"]


def hold_buckets(label: str, got, want) -> None:
    """K11's Buckets against bucket_clusters_plain's: vals, bounds and
    slots bitwise, the work list (its first n_units rows) as a set of
    rows, ordered longest member count (bit length) first; fails
    otherwise."""
    import torch

    same = all(torch.equal(g, w) for g, w in (
        (got.vals, want.vals), (got.bounds, want.bounds)))
    if want.slots is not None:
        n_units = int(got.n_units[0])
        rows = [tuple(r) for r in got.units[:n_units].tolist()]
        length = [int(m).bit_length() for *_, m in rows]
        same = same and torch.equal(got.slots, want.slots) \
            and sorted(rows) == sorted(
                tuple(r) for r in want.units.tolist()) \
            and length == sorted(length, reverse=True)
    if not same:
        fail(f"{label}: K11 differs from bucket_clusters_plain")


def hold_k11(label: str, x, c: int, spill: int):
    """K11 on the (N, p) ids x over c clusters: the member side of its
    first `spill` columns and the probe side of all p, each twice,
    bitwise bucket_clusters_plain (hold_buckets) and from the same run
    twice, and expanded (ivf.expand_buckets) bitwise member_table_plain and
    probe_tables_plain at tables as wide as their largest cluster rounded
    up to 128. Returns the two sides."""
    import torch

    from fedrann_tpu_torch.knn import ivf

    p = x.shape[1]
    a = x[:, :spill].reshape(-1).contiguous()
    flat = x.reshape(-1).contiguous()
    members = ivf.bucket_clusters(a, c, spill)
    queries = ivf.bucket_clusters(flat, c, p, members.bounds)
    again = (ivf.bucket_clusters(a, c, spill),
             ivf.bucket_clusters(flat, c, p, members.bounds))
    want = ivf.bucket_clusters_plain(a, c, spill)
    for got in (members, again[0]):
        hold_buckets(f"{label}, member side (spill {spill})", got, want)
    want_q = ivf.bucket_clusters_plain(flat, c, p, want.bounds)
    for got in (queries, again[1]):
        hold_buckets(f"{label}, probe side (p = {p})", got, want_q)
    counts = torch.bincount(a, minlength=c)
    qcounts = torch.bincount(flat, minlength=c)
    m, qm = (ivf._ceil128(int(t.max())) for t in (counts, qcounts))
    table_q, table_s = ivf.probe_tables_plain(x, qcounts, c, qm)
    n = x.shape[0]
    if not (torch.equal(ivf.expand_buckets(members.vals, members.bounds, m,
                                           n),
                        ivf.member_table_plain(a, counts, c, m, spill))
            and torch.equal(ivf.expand_buckets(queries.vals, queries.bounds,
                                               qm, n), table_q)
            and torch.equal(ivf.expand_buckets(queries.slots,
                                               queries.bounds, qm, 0),
                            table_s)):
        fail(f"{label}: K11's buckets expand to other tables than "
             "member_table_plain's and probe_tables_plain's")
    return members, queries


def k11_edge_cases(dev, card: str) -> None:
    """K11 on the card (hold_k11: both sides, bitwise their plain
    versions and the dense tables): every odd cluster empty, C = 1, N = 4
    K9_TILE + 77 (not a multiple of a tile), p = C = 8 (each row a
    permutation of the clusters), a strided spill-1 slice (as knn_ivf
    takes it), C = 2,048, 4,096 and 12,288 (counts filling all 48 KB of
    shared memory a block), and C = 16,384 and 65,536 (the counts in
    device memory), spill 1 and 2."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn import ivf

    rng = np.random.default_rng(11)
    cases = []
    for label, n, c, per in (("empty clusters", 3000, 64, 2),
                             ("C = 1", 700, 1, 1),
                             ("N = 4 K9_TILE + 77", 4 * ivf.K9_TILE + 77, 37,
                              2),
                             ("p = C = 8", 500, 8, 8),
                             ("C = 2,048", 60_000, 2048, 8),
                             ("C = 4,096", 60_000, 4096, 2),
                             ("C = 12,288", 30_000, 12_288, 2),
                             ("C = 16,384", 20_000, 16_384, 2),
                             ("C = 65,536", 5000, 65_536, 2)):
        x = (np.stack([rng.permutation(c) for _ in range(n)])
             if per == c else np.stack([rng.choice(c, per, replace=False)
                                        for _ in range(n)]))
        if label == "empty clusters":
            x = x - x % 2
        cases.append((label, torch.from_numpy(x.astype(np.int32)).to(dev),
                      c))
    top = cases[0][1]
    cases.append(("a strided spill-1 slice", top[:, :1], 64))
    for label, x, c in cases:
        for spill in sorted({1, x.shape[1]}):
            hold_k11(f"12 K11 edge case {label}", x, c, spill)
    log("12 K11 bitwise bucket_clusters_plain, member_table_plain and "
        "probe_tables_plain (both sides, two calls) at "
        + ", ".join(c[0] for c in cases) + f" [{card}]")


def check_tables(label: str, en, c: int, card: str) -> dict:
    """K11 on the unit rows en (N, d) at C = c with their own k-means's
    spill and probe lists (the member side at spill 1 and 2, the probe
    side of p = 8 over spill 2's bounds, as knn_ivf takes them): bitwise
    its plain version and the dense tables (hold_k11); each side's whole
    step (the wrapper and its one launch) timed, the median of 7
    timings, with its device us, and behind a busy card its call's host
    time and its device time by events (behind_busy_card), beside
    bucket_clusters_plain and a torch.sort(stable=True) of the same ids
    timed the same ways (a
    reference: it sorts, and makes no bounds or units); its bound the
    bytes: the ids read, vals (and slots) written, the bounds written (the
    member side's read on the probe side) and the units this run made.
    Returns the member side's report entry at spill 2."""
    import torch

    from fedrann_tpu_torch.knn import ivf

    _, top = ivf._tables(en, c, 3, 2, 8)
    report = {}
    sides = {spill: hold_k11(label, top[:, :8], c, spill)
             for spill in (1, 2)}
    members = sides[2][0]
    for spill in (1, 2, "probes"):
        if spill == "probes":
            ids = top[:, :8].reshape(-1).contiguous()
            mb = members.bounds

            def k11():
                return ivf.bucket_clusters(ids, c, 8, mb)

            def plain():
                return ivf.bucket_clusters_plain(ids, c, 8, mb)
            what = "probe side, p = 8"
            got = sides[2][1]
            n_units = int(got.n_units[0])
            out = 2 * ids.numel() * 4 + 2 * (c + 1) * 4 + n_units * 16 + 4
        else:
            ids = top[:, :spill].reshape(-1).contiguous()

            def k11():
                return ivf.bucket_clusters(ids, c, spill)

            def plain():
                return ivf.bucket_clusters_plain(ids, c, spill)
            what = f"member side, spill {spill}"
            got = sides[spill][0]
            n_units = 0
            out = ids.numel() * 4 + (c + 1) * 4
        sizes = torch.diff(got.bounds)
        ms, ms_range = time_cuda_median(k11, 20, 7)
        sort_ms, sort_range = time_cuda_median(
            lambda: torch.sort(ids, stable=True), 20, 7)
        plain_ms = time_cuda(plain, 10)
        enqueue_us, events_us = behind_busy_card(k11, 20)
        sort_enqueue, sort_events = behind_busy_card(
            lambda: torch.sort(ids, stable=True), 20)
        b = bound(ids.numel() * 4 + out)
        below = "below" if ms < sort_ms else "NOT below"
        log(f"{label} {what} ({ids.numel()} ids, largest cluster "
            f"{int(sizes.max())}, {int((sizes == 0).sum())} empty"
            + (f", {n_units} units" if n_units else "") + f"): {ms:.4f} ms "
            f"a step (median; {ms_range[0]:.4f}-{ms_range[1]:.4f}), device "
            f"{device_us(k11, 5, True)} us a step; behind a busy card "
            f"{enqueue_us:.1f} us of host time a call, {events_us:.1f} us "
            f"of device time by events; torch.sort(stable=True) of the ids "
            f"{sort_ms:.4f} ms (median; {sort_range[0]:.4f}-"
            f"{sort_range[1]:.4f}; K11 {below} it; behind a busy card "
            f"{sort_enqueue:.1f} / {sort_events:.1f} us); plain (sort, "
            f"bincount, units) {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.5f} ms (bytes, {100 * b['bound_ms'] / ms:.1f}% "
            f"of it); bitwise the plain buckets and the dense tables, two "
            f"calls equal [{card}]")
        report[spill] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             library_ms=None, **b)
    return report[2]


def check_sign_table(label: str, lib_size: int, d: int, seed: int,
                     density, dev, card: str) -> dict:
    """K5 against sign_table_plain on the card, bitwise, at a library of
    lib_size k-mers (density None: the CLI's 1/sqrt(2L)), with its time,
    the plain version's and its bound: the table's bytes written once, or
    the integer-pipe instructions csrc/srp_signs.cu counts a field
    (SIGN_FIELD_INSTR) over 2d fields a row. Returns its report entry."""
    import re

    import torch

    from fedrann_tpu_torch.project.srp import (
        seed_mix_of,
        sign_table,
        sign_table_plain,
    )

    density = density or 1.0 / (2 * lib_size) ** 0.5
    mix = seed_mix_of(seed)
    got = sign_table(lib_size, d, mix, density, dev)
    if not torch.equal(got, sign_table_plain(lib_size, d, mix, density,
                                             dev)):
        fail(f"{label}: K5 differs from its plain version")
    with open(os.path.join(HERE, CSRC, "srp_signs.cu")) as f:
        instr = int(re.search(r"constexpr int SIGN_FIELD_INSTR = (\d+);",
                              f.read()).group(1))
    ms = time_cuda(lambda: sign_table(lib_size, d, mix, density, dev), 10)
    plain_ms = time_cuda(lambda: sign_table_plain(lib_size, d, mix,
                                                  density, dev), 2)
    b = bound(got.numel() * 4, int32_ops=lib_size * 2 * d * instr)
    log(f"{label}: L = {lib_size}, d = {d}, table {tuple(got.shape)} "
        f"bitwise the plain one; {ms:.4f} ms, device "
        f"{device_us(lambda: sign_table(lib_size, d, mix, density, dev), 5, True)}"
        f" us a launch; plain {plain_ms:.4f} ms; bound "
        f"{b['bound_ms']:.5f} ms ({b['bound_by']}: {instr} instructions a "
        f"field; {100 * b['bound_ms'] / ms:.1f}% of it) [{card}]")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                **b)


def paired_case(counts, d: int, seed: int, density, dev):
    """(icf, density, seed_mix, scale) of the projection over `counts` on
    the card, and a run(table_fn, dtype) that builds the table with
    paired_table or paired_table_plain from them."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.project.srp import _stream

    icf, dens, mix, scale = _stream(
        torch.from_numpy(np.asarray(counts, np.int64)).to(dev), d, seed,
        density)

    def run(table_fn, dtype):
        return table_fn(icf, d, mix, dens, scale, dtype)

    return run


def check_paired_table(label: str, counts, d: int, seed: int, density,
                       dev, card: str) -> dict:
    """K8 against paired_table_plain on the card, bitwise (as integer
    views), over a library of len(counts) k-mers (density None: the CLI's
    1/sqrt(2L)), in float32 and bfloat16, each with its time, device us,
    the plain version's time and its bound: the table's bytes written
    once and the magnitudes read, or the integer-pipe instructions
    csrc/srp_signs.cu counts an entry (PAIRED_FIELD_INSTR) over 2d entries
    a row. Returns the float32 table's report entry."""
    import re

    import torch

    from fedrann_tpu_torch.project.srp import paired_table, paired_table_plain

    lib_size = len(counts)
    run = paired_case(counts, d, seed, density, dev)
    with open(os.path.join(HERE, CSRC, "srp_signs.cu")) as f:
        instr = int(re.search(r"constexpr int PAIRED_FIELD_INSTR = (\d+);",
                              f.read()).group(1))
    report = {}
    for dtype, view in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        got = run(paired_table, dtype)
        if not torch.equal(got.view(view),
                           run(paired_table_plain, dtype).view(view)):
            fail(f"{label}: K8 ({dtype}) differs from its plain version")
        ms = time_cuda(lambda: run(paired_table, dtype), 10)
        plain_ms = time_cuda(lambda: run(paired_table_plain, dtype), 2)
        b = bound(got.numel() * got.element_size() + lib_size * 4,
                  int32_ops=lib_size * 2 * d * instr)
        floor_ms = time_cuda(lambda: got.fill_(0), 10)
        was = EARLIER_MS.get(("srp_paired", lib_size, str(dtype)[6:]))
        log(f"{label}: L = {lib_size}, d = {d}, {dtype} table "
            f"{tuple(got.shape)} bitwise the plain one; {ms:.4f} ms"
            + ("" if was is None else f" [earlier {was:.4f}]") + ", device "
            f"{device_us(lambda: run(paired_table, dtype), 5, True)} us a "
            f"launch; plain {plain_ms:.4f} ms; store floor (fill_ of a "
            f"table of its shape and dtype, a floor, not a call that "
            f"computes it) {floor_ms:.4f} ms; bound {b['bound_ms']:.5f} ms "
            f"({b['bound_by']}: {got.numel() * got.element_size()} bytes, "
            f"{instr} instructions an entry; "
            f"{100 * b['bound_ms'] / ms:.1f}% of it) [{card}]")
        report[dtype] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             library_ms=None, **b)
        del got
    return report[torch.float32]


def k8_edge_cases(dev, card: str) -> None:
    """K8 bitwise paired_table_plain on the card in both dtypes: L = 0
    (only the zero row) and L = 1, d = 1 and d = 100 (a ragged vector;
    bfloat16's on the scalar path), density 1.0 and 1e-30 (a negative
    bound: no entry), counts equal to 2L (an ICF of ~1e-14) and a seed
    whose key has its top bit set."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.project.srp import (
        paired_table,
        paired_table_plain,
        seed_mix_of,
    )

    top = next(s for s in range(100) if int(seed_mix_of(s)) < 0)
    rng = np.random.default_rng(8)
    counts = rng.integers(2, 50, 1000)
    twice = np.where(np.arange(1000) % 3 == 0, 2000, counts)
    cases = [("L = 0", counts[:0], 512, None, 2094),
             ("L = 1", counts[:1], 512, None, 2094),
             ("d = 1", counts, 1, 0.5, 2094),
             ("d = 100", counts, 100, None, 2094),
             ("density 1.0", counts, 512, 1.0, 2094),
             ("a negative bound", counts, 512, 1e-30, 2094),
             ("counts equal to 2L", twice, 512, None, 2094),
             (f"seed {top}, its key's top bit set", counts, 512, None, top)]
    for label, c, d, density, seed in cases:
        run = paired_case(c, d, seed, density, dev)
        for dtype, view in ((torch.float32, torch.int32),
                            (torch.bfloat16, torch.int16)):
            got = run(paired_table, dtype)
            if got.shape != (len(c) + 1, 2 * d) or not torch.equal(
                    got.view(view), run(paired_table_plain, dtype).view(view)):
                fail(f"12 K8 edge case {label} ({dtype}): differs from "
                     "paired_table_plain")
    log("12 K8 bitwise paired_table_plain in float32 and bfloat16 at "
        + ", ".join(c[0] for c in cases) + f" [{card}]")


@contextlib.contextmanager
def knn_first_run_split():
    """Around phase 4's CLI run, the first K4 launches of the process:
    times, each between two synchronizes, the kernel library's load at
    each K4 launch (_build.kernels; the run's first staging kernel has
    loaded it) and each launch (with its CUDA event time), and every
    keys_to_host call. Yields the dict it fills."""
    import torch

    from fedrann_tpu_torch import _build
    from fedrann_tpu_torch.knn import topk

    launch, to_host = _build.launch, topk.keys_to_host
    split = {"library": [], "launches": [], "keys_to_host": []}

    def timed_launch(name, *args, **kwargs):
        if name != "fk_knn_merge":
            return launch(name, *args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _build.kernels()
        split["library"].append(time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        launch(name, *args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        split["launches"].append((time.perf_counter() - t0,
                                  start.elapsed_time(end) / 1e3))

    def timed_to_host(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = to_host(*args, **kwargs)
        split["keys_to_host"].append(time.perf_counter() - t0)
        return out

    _build.launch, topk.keys_to_host = timed_launch, timed_to_host
    try:
        yield split
    finally:
        _build.launch, topk.keys_to_host = launch, to_host


def read_overlaps(path: str):
    """(header, rows per (query, orientation)); fails on a distance
    outside [0, 2]."""
    per_query: dict[tuple[str, str], int] = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            q, qo, _t, _to, _rank, dist = line.rstrip("\n").split("\t")
            per_query[(q, qo)] = per_query.get((q, qo), 0) + 1
            if not 0.0 <= float(dist) <= 2.001:
                fail(f"distance {dist} outside [0, 2]")
    return header, per_query


def register_counters() -> None:
    """Fill COUNTERS (kernel -> (wrapper, its launch count): one count per
    path of kernel B and per source of the window-code kernels) and
    HOST_COUNTERS (host-side counts read around each CLI run)."""
    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.io import native
    from fedrann_tpu_torch.io.cache import load_packed_cache
    from fedrann_tpu_torch.io.fastx import read_fastx
    from fedrann_tpu_torch.io.packing import pack_reads
    from fedrann_tpu_torch.kmers.codec import canonical_sample
    from fedrann_tpu_torch.kmers.membership import (
        select_candidates,
        stage_candidates,
    )
    from fedrann_tpu_torch.knn.ivf import (
        bucket_clusters,
        knn_ivf,
        knn_ivf_sharded,
        knn_ivf_sharded_multihost,
        merge_probe_lists,
        rescore_clusters,
        segment_sum_rows,
    )
    from fedrann_tpu_torch.knn.ooc import knn_exact_ooc, knn_ivf_ooc
    from fedrann_tpu_torch.knn.ring import knn_exact_sharded
    from fedrann_tpu_torch.knn.topk import merge_block, result_wire
    from fedrann_tpu_torch.logging_utils import logger
    from fedrann_tpu_torch.project.embed import (
        membership_embed,
        membership_embed_dense,
    )
    from fedrann_tpu_torch.project.srp import paired_table, sign_table

    COUNTERS.update({
        **{f"stage_rows{sfx}": (stage_candidates, f"{src}_launches")
           for sfx, src in (("", "bytes"), ("_packed", "packed"),
                            ("_bits", "bits"))},
        **{f"canonical_sample{sfx}": (canonical_sample, f"{src}_launches")
           for sfx, src in (("", "bytes"), ("_packed", "packed"),
                            ("_bits", "bits"))},
        "select_candidates_long": (select_candidates, "long_launches"),
        "membership_embed": (membership_embed, "launches"),
        "membership_embed_dense": (membership_embed_dense, "launches"),
        "knn_merge": (merge_block, "kernel_launches"),
        "knn_merge_fp32": (merge_block, "fp32_launches"),
        "ivf_rescore": (rescore_clusters, "kernel_launches"),
        "ivf_rescore_fp32": (rescore_clusters, "fp32_launches"),
        "ivf_merge": (merge_probe_lists, "kernel_launches"),
        "ivf_segment_sum": (segment_sum_rows, "kernel_launches"),
        "ivf_buckets": (bucket_clusters, "kernel_launches"),
        "ivf_buckets_probe": (bucket_clusters, "probe_launches"),
        "result_wire": (result_wire, "kernel_launches"),
        "srp_signs": (sign_table, "kernel_launches"),
        "srp_paired": (paired_table, "kernel_launches")})
    HOST_COUNTERS.update({
        "pack_reads_native": (native.pack_reads_native, "calls"),
        "read_fastx": (read_fastx, "calls"),
        "pack_reads": (pack_reads, "calls"),
        "cache_hits": (load_packed_cache, "hits"),
        "pin_copies": (pipeline.upload_bucket, "pin_copies"),
        "ooc_slabs": (knn_exact_ooc, "slabs"),
        "ooc_blocks": (knn_exact_ooc, "blocks_uploaded"),
        "ooc_h2d_bytes": (knn_exact_ooc, "h2d_bytes"),
        "sharded_knn_calls": (knn_exact_sharded, "calls"),
        "ivf_calls": (knn_ivf, "calls"),
        "ivf_fallbacks": (knn_ivf, "exact_fallbacks"),
        "ivf_ooc_calls": (knn_ivf_ooc, "calls"),
        "ivf_sharded_calls": (knn_ivf_sharded, "calls"),
        "ivf_multihost_calls": (knn_ivf_sharded_multihost, "calls")})

    class LibrarySizes(logging.Handler):
        def emit(self, record: logging.LogRecord) -> None:
            if record.msg.startswith("library: "):
                LIBRARY_SIZES.append(int(record.args[0]))

    logger.addHandler(LibrarySizes())


def main() -> None:
    import numpy as np
    import torch

    args = sys.argv[1:]
    if args not in ([], ["--profile"]):
        fail(f"usage: python3 chip_smoke.py [--profile], not {args}")
    profiling = args == ["--profile"]
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import fedrann_tpu_torch  # noqa: F401
        from fedrann_tpu_torch import _build
        from fedrann_tpu_torch.cli import config_from_args
        from fedrann_tpu_torch.device import get_device
        from fedrann_tpu_torch.io import native
        from fedrann_tpu_torch.kmers.membership import STATIC_SMEM
        from fedrann_tpu_torch.sim import simulate_reads, write_fasta
        register_counters()
    except ImportError as e:
        fail(f"cannot import the port from {HERE}: {e}")

    dev = get_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.basename(so)}")
    most = ctypes.c_int32(0)
    _build.launch("fk_stage_rows_static_smem", ctypes.addressof(most))
    if not 0 < most.value <= STATIC_SMEM:
        fail(f"a one-block kernel holds {most.value} B of static shared "
             f"memory, past the STATIC_SMEM ({STATIC_SMEM} B) its plan keeps")
    log(f"one-block kernels: at most {most.value} B of static shared "
        f"memory (STATIC_SMEM {STATIC_SMEM} B)")
    build_log = str(so) + ".log"
    if os.path.exists(build_log):
        for line in open(build_log).read().splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  ptxas: {line.strip()}")
    # 2b: the host library, from native/fastxpack.cpp into _kernels/
    t0 = time.perf_counter()
    host_so = _build.build_host()
    lib = native.load_native()
    log(f"host library build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(lib._name, HERE)}")
    if (os.path.realpath(os.path.dirname(lib._name))
            != os.path.realpath(_build.BUILD_DIR)
            or os.path.realpath(lib._name) != os.path.realpath(host_so)):
        fail(f"the host library loaded from {lib._name}, not from "
             f"{_build.BUILD_DIR}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim = simulate_reads(genome_length=GENOME, coverage=COVERAGE,
                             mean_read_length=READ_LEN,
                             error_rate=ERROR_RATE, seed=SIM_SEED)
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, sim.names, sim.sequences)
        n_reads = len(sim.names)
        log(f"simulated {n_reads} reads in {time.perf_counter() - t0:.1f} s")

        report = check_kernels(fasta, os.path.join(tmp, "check"), dev, card)
        for name, r in report.items():
            log_kernel(name, r, card)

        with knn_first_run_split() as split:
            launches, secs = drive_cli(fasta, os.path.join(tmp, "out"), sim,
                                       MIN_OVERLAP, card, dev)
        first, rest = split["launches"][0], split["launches"][1:]
        log(f"4 knn first-run split: knn stage {secs['knn']:.4f} s = the "
            f"kernel library's load at the K4 launch "
            f"{sum(split['library']):.6f} s (loaded by the run's first "
            f"staging kernel) + the first K4 launch {first[0]:.4f} s (its "
            f"kernel {first[1]:.4f} s by events) + {len(rest)} more "
            f"launches {sum(r[0] for r in rest):.4f} s + keys_to_host "
            f"{sum(split['keys_to_host']):.4f} s + the rest (normalize, "
            f"the bf16 rows, timing syncs) [{card}]")
        phase4 = (dict(launches), secs)
        # 4c: the same again on the same -o: from the packed-reads cache
        _, secs_c = drive_cli(fasta, os.path.join(tmp, "out"), sim,
                              MIN_OVERLAP, card, dev, load="cache")
        log(f"4c cache rerun: load {secs_c['load']:.3f} s from fxcache.npz, "
            f"phase 4 (native parse) {secs['load']:.3f} s; output "
            f"{secs_c['output']:.3f} s [{card}]")
        load_split(fasta, os.path.join(tmp, "load"), card)
        if profiling:
            profile_cli(fasta, os.path.join(tmp, "prof"), card, "main path")
        # 4b: the main path with dense paired tables: kernel C's dense form
        dense_launches = paired_launches = 0
        for dtype in ("f32", "bf16"):
            runs, secs_d = drive_cli(
                fasta, os.path.join(tmp, f"out_{dtype}"), sim, MIN_OVERLAP,
                card, dev, [*FLAGS, "--projection-dtype", dtype],
                "membership_embed_dense")
            dense_launches += runs["membership_embed_dense"]
            paired_launches += runs["srp_paired"]
            log(f"4b --projection-dtype {dtype}: project "
                f"{secs_d['project']:.3f} s (K8 {runs['srp_paired']} "
                f"launch; the table by torch ops: "
                f"{PROJECT_TORCH_OPS_S[dtype]:.3f} s), embed "
                f"{secs_d['embed']:.3f} s; phase 4 (signs): project "
                f"{secs['project']:.3f} s, embed {secs['embed']:.3f} s "
                f"[{card}]")
        # 4d: checkpoints and a resumed rerun; 4e: the feature flags
        check_checkpoints(fasta, os.path.join(tmp, "ckpt"), sim, card, dev)
        check_feature_flags(fasta, os.path.join(tmp, "flags"), sim, card,
                            dev)
        # 4f: K4's fp32 form through the CLI, in core and out of core
        fp32_launches = check_fp32_cli(
            fasta, os.path.join(tmp, "fp32"),
            os.path.join(tmp, "out", "overlaps.tsv"), sim, card, dev, secs)
        # 12: K4 and K5 against their plain versions (phase 4's rows and
        # library from 4d's checkpoints)
        report.update(check_knn_kernels(
            os.path.join(tmp, "ckpt", "checkpoints"), dev, card))
        report.update(check_ivf_kernels(
            os.path.join(tmp, "ckpt", "checkpoints"), dev, card))
        # 8: out of core, on phase 4's reads (8a) and at 262,144 rows (8b)
        launches["membership_embed"] += check_ooc_cli(
            fasta, os.path.join(tmp, "ooc"),
            os.path.join(tmp, "out", "overlaps.tsv"), sim, card,
            dev)["membership_embed"]
        # 8a again under --profile: the merge launches inside the profiler
        launches["membership_embed"] += check_ooc_profile(
            fasta, os.path.join(tmp, "ooc_prof"),
            os.path.join(tmp, "out", "overlaps.tsv"), sim, card,
            dev)["membership_embed"]
        exact_ooc_secs = check_ooc_search(dev, card)
        # 9: the sharded k-NN and step, over SHARD_ENTRIES entries of this
        # card (9a-9c) and over every card where there are more (9d)
        check_sharded_search([dev] * SHARD_ENTRIES, card,
                             f"{SHARD_ENTRIES} entries of {dev}")
        for name, n in check_sharded_cli(
                fasta, os.path.join(tmp, "sharded"),
                os.path.join(tmp, "out", "overlaps.tsv"), sim, card, dev,
                phase4).items():
            if name in ("membership_embed", *STAGE_KERNELS):
                launches[name] += n
        inputs = step_inputs(fasta, dev)
        step_launches = check_sharded_step(
            inputs, [dev] * SHARD_ENTRIES, card,
            f"{SHARD_ENTRIES} entries of {dev}")
        check_other_cards(inputs, card)
        del inputs
        # 10: two rank processes of the CLI (the multi-process runtime)
        for name, n in check_multiprocess(
                fasta, os.path.join(tmp, "multi"), sim, card, dev,
                os.path.join(tmp, "out", "overlaps.tsv"),
                os.path.join(tmp, "ckpt", "checkpoints",
                             "library.npz")).items():
            if name in ("membership_embed", *STAGE_KERNELS):
                launches[name] += n
        # 11: the IVF k-NN on every path; K6 and K7 launch on its CLI runs
        ivf_launches = check_ivf(
            fasta, os.path.join(tmp, "ivf"), sim, card, dev,
            os.path.join(tmp, "out", "overlaps.tsv"),
            os.path.join(tmp, "ckpt", "checkpoints", "library.npz"),
            exact_ooc_secs)
        for name, n in ivf_launches.items():
            if name in ("membership_embed", *STAGE_KERNELS):
                launches[name] += n
        launches.update(
            ivf_rescore=(ivf_launches["ivf_rescore"]
                         - ivf_launches["ivf_rescore_fp32"]),
            ivf_rescore_fp32=ivf_launches["ivf_rescore_fp32"],
            ivf_merge=ivf_launches["ivf_merge"],
            ivf_segment_sum=ivf_launches["ivf_segment_sum"],
            ivf_buckets=ivf_launches["ivf_buckets"],
            srp_paired=paired_launches)
        log(f"11 CLI runs: K4 {ivf_launches['knn_merge']} launches "
            f"({ivf_launches['knn_merge_fp32']} fp32), K6 "
            f"{ivf_launches['ivf_rescore']} ({launches['ivf_rescore_fp32']} "
            f"fp32), K7 {launches['ivf_merge']}, K9 "
            f"{launches['ivf_segment_sum']}, K10 "
            f"{ivf_launches['result_wire']}, K11 {launches['ivf_buckets']} "
            f"[{card}]")

        t0 = time.perf_counter()
        sim = simulate_reads(genome_length=LONG_GENOME,
                             coverage=LONG_COVERAGE,
                             mean_read_length=LONG_READ_LEN,
                             error_rate=ERROR_RATE, seed=SIM_SEED)
        fasta = os.path.join(tmp, "long.fasta")
        write_fasta(fasta, sim.names, sim.sequences)
        log(f"simulated {len(sim.names)} long reads in "
            f"{time.perf_counter() - t0:.1f} s")
        report.update(check_long_rows(sim, fasta, os.path.join(tmp, "lchk"),
                                      dev, card))
        long_launches, _ = drive_cli(fasta, os.path.join(tmp, "lout"), sim,
                                     LONG_MIN_OVERLAP, card, dev)
        config = config_from_args(["-i", "-", "-o", "-", *FLAGS])
        check_sign_table("12 K5 at the long reads' library",
                         LIBRARY_SIZES[-1], config.embedding_dimension,
                         config.projection_seed, config.projection_density,
                         dev, card)
        check_paired_table("12 K8 at the long reads' library",
                           np.random.default_rng(LIBRARY_SIZES[-1]).integers(
                               2, 50, LIBRARY_SIZES[-1]),
                           config.embedding_dimension,
                           config.projection_seed, config.projection_density,
                           dev, card)
        if profiling:
            profile_cli(fasta, os.path.join(tmp, "lprof"), card, "long reads")
        # 5d: ultra-long reads past the largest bucket, split and merged
        check_split_reads(sim, os.path.join(tmp, "split"), dev, card)

        # 5c: keep_all reads past one block's shared memory, so that a CLI
        # run drives kernel B's device-memory path
        sim = simulate_reads(genome_length=KEEP_ALL_GENOME, coverage=8,
                             mean_read_length=KEEP_ALL_READ_LEN,
                             error_rate=ERROR_RATE, seed=SIM_SEED)
        fasta = os.path.join(tmp, "keep_all.fasta")
        write_fasta(fasta, sim.names, sim.sequences)
        flags = [*FLAGS, "--kmer-sample-fraction", "1.0"]
        if "select_candidates_long" not in stage_paths(sim, flags, dev):
            fail("no bucket of the keep_all reads takes kernel B's "
                 "device-memory path")
        check_keep_all_rows(sim, flags, dev, card)
        log(f"keep_all run: {len(sim.names)} reads of ~{KEEP_ALL_READ_LEN} "
            "bases at --kmer-sample-fraction 1.0")
        keep_all_launches, _ = drive_cli(
            fasta, os.path.join(tmp, "kout"), sim, KEEP_ALL_READ_LEN // 2,
            card, dev, flags)
        for name in STAGE_KERNELS:  # the fused kernels: the main path's
            if not name.startswith("stage_rows"):
                launches[name] += (long_launches[name]
                                   + keep_all_launches[name])

        # 7: golden parity against the reference's own artifacts
        dense_launches += check_golden(os.path.join(tmp, "golden"), dev,
                                       card)
        launches["membership_embed_dense"] = dense_launches
        for name, n in step_launches.items():
            launches[name] += n
        launches["knn_merge_fp32"] = fp32_launches

    report.update(check_probes(dev, card))
    launches.update(drive_probes())

    if "jax" in sys.modules or "fedrann_tpu" in sys.modules:
        fail("the port imported jax or fedrann_tpu")
    with open("/proc/self/maps") as f:
        if os.path.realpath(os.path.join(HERE, "native",
                                         "libfastxpack.so")) in f.read():
            fail("native/libfastxpack.so was loaded")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **{key: report[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for name in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
