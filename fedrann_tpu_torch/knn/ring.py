"""Sharded exact k-NN over a device mesh: ring, allgather and ring2d (the
port of `fedrann_tpu/knn/ring.py` `knn_exact_sharded`).

Rows are zero-padded to a multiple of the mesh size and cut into one block
per mesh entry (parallel/mesh.py); entry i owns the query rows and the
candidate block [i*b, (i+1)*b). Each entry folds the candidate blocks it
sees into the running int64 keys of its query tiles with
`topk.merge_block`, the step `knn_exact` and the out-of-core search take,
so the scores and the tie order (score descending, then the lowest global
index) are `knn_exact`'s. The JAX package's ring instead lets `top_k`'s
position break ties, preferring the block that arrived first: a deliberate
divergence (ROADMAP Queue 3).

- **ring**: at each of n steps every entry merges the block it holds, then
  takes the block of entry (i - 1) % n: at step s entry i holds the block
  of entry (i - s) % n. n - 1 hops (JAX's last ppermute, which returns
  every block home, is not made).
- **allgather**: every entry gathers all real rows, then scans them in
  candidate tiles.
- **ring2d**: on a ("hosts", "data") mesh, n_local inner steps over the
  data axis, then one hop to the same lane of the next host, n_hosts
  times. A round's last inner hop and the host hop are made as one:
  entry (h, j) takes the block entry (h - 1, j - 1) holds, which is the
  block entry (h - 1, j) started the round with.

Each entry's queries are tiled by query_tile and each block by a candidate
tile (`_fit_tile`), so no (b, b) score tile is ever made. Padding rows
never win a slot (a block is sliced to its real rows) and padding query
rows are dropped, so no index >= N leaves the function. Blocks move with
`mesh.to_device` (`Tensor.to(device, non_blocking=True)` between cards,
which orders the copy after the work of both devices' current streams);
each step's merges are issued entry by entry before anything
synchronises, so distinct cards run at once. A copy to the device a block
already lies on is that block, so no block is modified in place.
"""

from __future__ import annotations

import numpy as np
import torch

from fedrann_tpu_torch.knn.topk import (
    _fit_tile,
    keys_to_host,
    merge_block,
    unit_rows,
)
from fedrann_tpu_torch.parallel.mesh import (
    HOST_AXIS,
    Mesh,
    make_mesh,
    pad_rows_to_multiple,
    shard_rows,
    to_device,
)

STRATEGIES = ("ring", "allgather", "ring2d")


def _check_strategy(mesh: Mesh, strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, not "
                         f"{strategy!r}")
    if strategy == "ring2d" and HOST_AXIS not in mesh.axis_names:
        raise ValueError(
            "strategy 'ring2d' needs a 2-D ('hosts', 'data') mesh — build "
            "it with make_mesh_2d(n_hosts)")


def _hops(mesh: Mesh, strategy: str):
    """For each step after the first of a ring schedule, the entry each
    entry takes its next block from."""
    n = mesh.size
    if strategy == "ring":
        for _ in range(n - 1):
            yield [(i - 1) % n for i in range(n)]
        return
    n_hosts, n_local = mesh.shape
    for t in range(n_hosts):
        for s in range(n_local):
            if t == n_hosts - 1 and s == n_local - 1:
                return
            dh = 1 if s == n_local - 1 else 0  # the round's host hop
            yield [((h - dh) % n_hosts) * n_local + (j - 1) % n_local
                   for h in range(n_hosts) for j in range(n_local)]


def _fold(runs: list, queries: torch.Tensor, block: torch.Tensor,
          first: int, k: int, ct: int, qt: int) -> None:
    """Merge candidate rows `block`, global rows first.., into the running
    keys runs[t] of each query tile queries[t*qt : (t+1)*qt]."""
    for t in range(len(runs)):
        q = queries[t * qt : (t + 1) * qt]
        for c0 in range(0, block.shape[0], ct):
            runs[t] = merge_block(runs[t], q, block[c0 : c0 + ct],
                                  first + c0, k)
            knn_exact_sharded.merges += 1


def sharded_topk(shards: list[torch.Tensor], mesh: Mesh, n_real: int,
                 k: int, strategy: str = "ring",
                 candidate_tile: int = 131072,
                 query_tile: int = 512) -> list[torch.Tensor]:
    """The search over rows already cut into one (b, d) block per mesh
    entry, on its device, normalized as the search scores them
    (topk.unit_rows), global rows >= n_real being padding. Returns for
    each entry the int64 keys (real rows, k) of its real query rows
    (topk.keys_to_host decodes them); k <= n_real."""
    _check_strategy(mesh, strategy)
    b = shards[0].shape[0]
    real = [max(0, min(b, n_real - i * b)) for i in range(mesh.size)]
    queries = [s[:r] for s, r in zip(shards, real)]
    runs = [[None] * -(-r // query_tile) for r in real]
    if strategy == "allgather":
        ct = _fit_tile(candidate_tile, n_real)
        gathered: dict[torch.device, torch.Tensor] = {}
        for i, dev in enumerate(mesh.devices):
            if dev not in gathered:
                gathered[dev] = torch.cat([to_device(s[:r], dev)
                                           for s, r in zip(shards, real)])
            _fold(runs[i], queries[i], gathered[dev], 0, k, ct, query_tile)
    else:
        ct = _fit_tile(candidate_tile, b)
        held = list(enumerate(shards))  # (owner, block) at each entry
        hops = _hops(mesh, strategy)
        while True:
            for i, (owner, block) in enumerate(held):
                if real[owner]:
                    _fold(runs[i], queries[i], block[: real[owner]],
                          owner * b, k, ct, query_tile)
            src = next(hops, None)
            if src is None:
                break
            held = [(held[j][0], to_device(held[j][1], dev))
                    for j, dev in zip(src, mesh.devices)]
    return [torch.cat(r) for r in runs if r]


def knn_exact_sharded(
    embeddings,
    n_neighbors: int,
    mesh: Mesh | None = None,
    strategy: str = "ring",
    precision: str = "bf16",
    transfer: str = "f32",
    candidate_tile: int = 131072,
    query_tile: int = 512,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k with rows sharded over the mesh (every visible
    CUDA card when None). (N, d) embeddings, a tensor on any device or a
    numpy array -> (indices (N, k) int32, distances (N, k) float32) in
    global row numbering, sorted by ascending distance, k = min(n_neighbors,
    N): `knn_exact`'s result. Rows are normalized where they lie, then
    distributed. Counts its calls in `.calls`, the last call's mesh
    entries in `.devices` and every merge_block in `.merges`."""
    mesh = mesh if mesh is not None else make_mesh()
    emb = torch.as_tensor(embeddings)
    n = emb.shape[0]
    k = min(n_neighbors, n)
    padded, _ = pad_rows_to_multiple(unit_rows(emb, precision), mesh.size)
    keys = sharded_topk(shard_rows(padded, mesh), mesh, n, k, strategy,
                        candidate_tile, query_tile)
    knn_exact_sharded.calls += 1
    knn_exact_sharded.devices = mesh.size
    parts = [keys_to_host(kk, transfer) for kk in keys]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


knn_exact_sharded.calls = 0
knn_exact_sharded.devices = 0
knn_exact_sharded.merges = 0
