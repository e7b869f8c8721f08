"""The fused sharded step: packed bases in, neighbor lists out (the port of
`fedrann_tpu/parallel/step.py`).

On each mesh entry, for the entry's own read rows: candidate staging
(`membership.stage_candidates`: on a CUDA device kernels A and B fused),
membership and embedding through kernel C's dense form
(`embed.membership_embed_dense`) on the replicated paired table, fwd/rev
rows interleaved and normalized; then the ring or allgather search over
the mesh (knn/ring.py `sharded_topk`). Read rows are data-parallel: entry
m owns reads [m*B, (m+1)*B), hence embedding rows [2mB, 2(m+1)B).

The JAX step's `bits`, `steps`, `table_packed` and `hit_buffer` describe
its TPU library index, which the port does not have: kernel C builds its
own prefix table of the sorted library.
"""

from __future__ import annotations

import numpy as np
import torch

from fedrann_tpu_torch.kmers.codec import sample_threshold
from fedrann_tpu_torch.kmers.membership import (
    selection_cap,
    stage_candidates,
    staging_width,
)
from fedrann_tpu_torch.knn.ring import sharded_topk
from fedrann_tpu_torch.knn.topk import keys_to_host, unit_rows
from fedrann_tpu_torch.parallel.mesh import Mesh, replicate, shard_rows
from fedrann_tpu_torch.project.embed import membership_embed_dense


def staging_args(w: int, max_hits: int | None, sampling: tuple | None):
    """(hit_buffer, keep_all, seed, threshold, block_cap) of a row of w
    windows, as the JAX package's `read_hits` sizes its staging:
    sampling=(seed, fraction) filters by the library's sampling hash (only
    right for a library sampled with exactly those), else every valid
    window is kept; max_hits caps the buffer; the width is a multiple of 8
    of at least 8 and at most w."""
    prefilter = sampling is not None and float(sampling[1]) < 1.0
    hit_buffer = staging_width(w, float(sampling[1])) if prefilter else w
    if max_hits is not None:
        hit_buffer = min(hit_buffer, max(1, int(max_hits)))
    hit_buffer = min(w, max(8, -(-hit_buffer // 8) * 8))
    if not prefilter:
        return hit_buffer, True, 0, 0, None
    fraction = float(sampling[1])
    return (hit_buffer, False, int(sampling[0]),
            sample_threshold(fraction), selection_cap(fraction))


def make_sharded_step(
    mesh: Mesh,
    k: int,
    max_hits: int | None,
    n_neighbors: int,
    precision: str = "bf16",
    strategy: str = "ring",
    sampling: tuple | None = None,
    n_reads: int | None = None,
):
    """The sharded step: fn(bases, lib_codes, p_pair), each a list with one
    entry per mesh entry (shard_step_inputs) -> (distances (2n, k_nn)
    float32, indices (2n, k_nn) int32) numpy arrays, n = n_reads, or every
    row when None. The rows of each entry's bases are that entry's reads;
    pass the real read count as n_reads, so that padding rows (embedding
    rows >= 2 * n_reads) never enter a real read's top-k, and their own
    lists are dropped."""
    def step(bases: list, lib_codes: list, p_pair: list):
        rows = bases[0].shape[0]
        hit_buffer, keep_all, seed, threshold, block_cap = staging_args(
            bases[0].shape[1] - k + 1, max_hits, sampling)
        shards = []
        for m in range(mesh.size):
            staged, _ = stage_candidates(bases[m], k, hit_buffer, keep_all,
                                         seed, threshold, block_cap)
            dev = staged.device
            emb = torch.zeros((2 * rows, p_pair[m].shape[1] // 2),
                              dtype=torch.float32, device=dev)
            targets = torch.arange(2 * rows, device=dev).view(rows, 2)
            membership_embed_dense(staged, lib_codes[m], p_pair[m], targets,
                                   emb)
            shards.append(unit_rows(emb, precision))
        n_real = 2 * rows * mesh.size if n_reads is None else 2 * n_reads
        keys = sharded_topk(shards, mesh, n_real, min(n_neighbors, n_real),
                            strategy, precision=precision)
        parts = [keys_to_host(kk, "f32", n_real) for kk in keys]
        return (np.concatenate([p[1] for p in parts]),
                np.concatenate([p[0] for p in parts]))

    return step


def shard_step_inputs(mesh: Mesh, bases, lib_codes: torch.Tensor,
                      p_pair: torch.Tensor) -> tuple[list, list, list]:
    """The step's inputs placed on the mesh: the bases ((R, L) uint8, or a
    codec.PackedChunk; R a multiple of the mesh size, padded with rows of
    no valid base) row-sharded; the sorted int64 library codes and the
    dense paired table (srp.build_precompute_paired, or
    convert.paired_table_to_port of the JAX package's) replicated."""
    return (shard_rows(bases, mesh), replicate(lib_codes, mesh),
            replicate(p_pair, mesh))
