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

On a CUDA mesh the merge kernel holds no tile, so an entry's queries and
a block are one launch; on the CPU the queries are tiled by query_tile and
each block by a candidate tile (`_fit_tile`), so no (b, b) score tile is
ever made. Padding rows never win a slot (a block is sliced to its real
rows) and padding query rows are dropped, so no index >= N leaves the
function. Blocks move with
`mesh.to_device` (`Tensor.to(device, non_blocking=True)` between cards,
which orders the copy after the work of both devices' current streams);
each step's merges are issued entry by entry before anything
synchronises, so distinct cards run at once. A copy to the device a block
already lies on is that block, so no block is modified in place.

`knn_exact_sharded_multihost` runs the same schedule over every process's
entries: a block that crosses processes goes over the run's device
transport (parallel/dist.py), one that stays moves as above.
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


def _hops(shape: tuple[int, ...], strategy: str):
    """For each step after the first of a ring schedule over entries laid
    out `shape` ((n,) for ring, (hosts, data) for ring2d), the entry each
    entry takes its next block from."""
    n = int(np.prod(shape))
    if strategy == "ring":
        for _ in range(n - 1):
            yield [(i - 1) % n for i in range(n)]
        return
    n_hosts, n_local = shape
    for t in range(n_hosts):
        for s in range(n_local):
            if t == n_hosts - 1 and s == n_local - 1:
                return
            dh = 1 if s == n_local - 1 else 0  # the round's host hop
            yield [((h - dh) % n_hosts) * n_local + (j - 1) % n_local
                   for h in range(n_hosts) for j in range(n_local)]


def _fold(runs: list, queries: torch.Tensor, block: torch.Tensor,
          first: int, k: int, ct: int, qt: int, precision: str) -> None:
    """Merge candidate rows `block`, global rows first.., into the running
    keys runs[t] of each query tile queries[t*qt : (t+1)*qt]."""
    for t in range(len(runs)):
        q = queries[t * qt : (t + 1) * qt]
        for c0 in range(0, block.shape[0], ct):
            runs[t] = merge_block(runs[t], q, block[c0 : c0 + ct],
                                  first + c0, k, precision)
            knn_exact_sharded.merges += 1


class _Moves:
    """How a block reaches another entry: by mesh.to_device inside this
    process, and over `transport` (parallel/dist.py DeviceTransport) to
    and from another process. Entries are global (every process's local
    entries, process-major); this process's are first .. first + n_local
    - 1, on `devices`."""

    def __init__(self, devices, transport=None):
        self.devices = list(devices)
        self.transport = transport
        self.rank = transport.group.rank if transport is not None else 0
        self.first = self.rank * len(self.devices)
        self._all = None

    def _process(self, entry: int) -> int:
        return entry // len(self.devices)

    def hop(self, held: list, src: list) -> list:
        """The blocks this process's entries hold after global entry e
        takes the block entry src[e] held."""
        sends, recvs = [], []
        for dst, s in enumerate(src):
            p_dst, p_src = self._process(dst), self._process(s)
            if p_dst == p_src:
                continue
            if p_src == self.rank:
                sends.append((p_dst, held[s - self.first]))
            if p_dst == self.rank:
                recvs.append((p_src, tuple(held[0].shape),
                              self.devices[dst - self.first]))
        received = iter(self.transport.exchange(sends, recvs)
                        if sends or recvs else ())
        mine = src[self.first : self.first + len(self.devices)]
        return [to_device(held[s - self.first], dev)
                if self._process(s) == self.rank else next(received)
                for s, dev in zip(mine, self.devices)]

    def gather(self, shards: list, dev: torch.device) -> torch.Tensor:
        """Every global entry's block, in order, on `dev`. Across
        processes the blocks are first gathered on the transport's hop
        device, once."""
        if self.transport is None:
            return torch.cat([to_device(s, dev) for s in shards])
        if self._all is None:
            hop = self.transport.hop_device
            self._all = torch.cat(self.transport.all_gather(
                torch.cat([to_device(s, hop) for s in shards])))
        return to_device(self._all, dev)


def sharded_topk(shards: list[torch.Tensor], mesh: Mesh, n_real: int,
                 k: int, strategy: str = "ring",
                 candidate_tile: int = 131072,
                 query_tile: int = 512, *,
                 transport=None,
                 precision: str = "bf16") -> list[torch.Tensor]:
    """The search over rows already cut into one (b, d) block per mesh
    entry, on its device, normalized as the search scores them
    (topk.unit_rows), global rows >= n_real being padding, merged at
    `precision`. Returns for each entry the int64 keys (real rows, k) of
    its real query rows (topk.keys_to_host decodes them); k <= n_real.

    With a `transport` the mesh is this process's part of the search: the
    global entries are every process's local entries in process-major
    order, and ring2d runs on (processes, local entries), its host hop
    being the one that crosses processes."""
    if transport is None:
        _check_strategy(mesh, strategy)
        shape = mesh.shape
    elif strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, not "
                         f"{strategy!r}")
    else:
        n_proc = transport.group.size
        shape = ((n_proc, mesh.size) if strategy == "ring2d"
                 else (n_proc * mesh.size,))
    moves = _Moves(mesh.devices, transport)
    first = moves.first
    b = shards[0].shape[0]
    real = [max(0, min(b, n_real - g * b))
            for g in range(int(np.prod(shape)))]
    queries = [s[: real[first + j]] for j, s in enumerate(shards)]
    # the merge kernel holds no tile: on a card one launch an entry a block
    on_card = mesh.devices[0].type == "cuda"
    if on_card:
        query_tile = max(b, 1)
    runs = [[None] * -(-q.shape[0] // query_tile) for q in queries]
    if strategy == "allgather":
        ct = max(n_real, 1) if on_card else _fit_tile(candidate_tile, n_real)
        gathered: dict[torch.device, torch.Tensor] = {}
        for j, dev in enumerate(mesh.devices):
            if dev not in gathered:  # padding sits only at the global tail
                gathered[dev] = moves.gather(shards, dev)[:n_real]
            _fold(runs[j], queries[j], gathered[dev], 0, k, ct, query_tile,
                  precision)
    else:
        ct = max(b, 1) if on_card else _fit_tile(candidate_tile, b)
        owners = list(range(len(real)))  # the block each entry holds
        held = list(shards)
        hops = _hops(shape, strategy)
        while True:
            for j, block in enumerate(held):
                owner = owners[first + j]
                if real[owner]:
                    _fold(runs[j], queries[j], block[: real[owner]],
                          owner * b, k, ct, query_tile, precision)
            src = next(hops, None)
            if src is None:
                break
            held = moves.hop(held, src)
            owners = [owners[s] for s in src]
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
                        candidate_tile, query_tile, precision=precision)
    knn_exact_sharded.calls += 1
    knn_exact_sharded.devices = mesh.size
    parts = [keys_to_host(kk, transfer, n) for kk in keys]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


knn_exact_sharded.calls = 0
knn_exact_sharded.devices = 0
knn_exact_sharded.merges = 0


def knn_exact_sharded_multihost(
    emb_local,
    n_reads_global: int,
    per_process_reads: int,
    n_neighbors: int,
    strategy: str = "ring",
    precision: str = "bf16",
    transfer: str = "f32",
    candidate_tile: int = 131072,
    *,
    mesh: Mesh,
    transport,
    query_tile: int = 512,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k over the entries of every process (the port of
    `fedrann_tpu/knn/ring.py` `knn_exact_sharded_multihost`).

    emb_local: this process's (2 * local reads, d) embedding rows, global
    rows [2 * rank * per, ...) of contiguous read ranges. The process's
    block is zero-padded to 2 * per rows (per = per_process_reads, which
    must leave 2 * per divisible by the local mesh size: process_quota
    with row_multiple = mesh.size), cut over its local mesh `mesh` and
    normalized there. The global entries are the processes' local
    entries in process-major order, entry g owning global rows [g * b, (g
    + 1) * b); padding sits only at the global tail (>= 2 *
    n_reads_global). ring and allgather run over all entries; ring2d runs
    on (processes, local entries), its host hop being the one that crosses
    processes: sharded_topk's schedule, inside a process a block moving
    by mesh.to_device and between processes over `transport`
    (parallel/dist.py DeviceTransport). Every tile goes through
    merge_block, so scores and ties are knn_exact's. Returns (indices
    int32, distances float32) of this process's real rows, in global row
    numbering; merges count in knn_exact_sharded.merges."""
    n_local = mesh.size
    block_rows = 2 * per_process_reads
    if block_rows % n_local:
        raise ValueError(
            f"per-process block of {block_rows} rows does not divide over "
            f"{n_local} local devices; compute the read range with "
            "host_read_range(..., row_multiple=local device count)")
    emb = torch.as_tensor(emb_local)
    n_mine, d = emb.shape
    local = emb.new_zeros((block_rows, d), dtype=torch.float32)
    local[:n_mine] = emb
    n_real = 2 * n_reads_global
    k = min(n_neighbors, n_real)
    keys = sharded_topk(shard_rows(unit_rows(local, precision), mesh), mesh,
                        n_real, k, strategy, candidate_tile, query_tile,
                        transport=transport, precision=precision)
    if not keys:
        return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
    parts = [keys_to_host(kk, transfer, n_real) for kk in keys]
    return (np.concatenate([p[0] for p in parts])[:n_mine],
            np.concatenate([p[1] for p in parts])[:n_mine])
