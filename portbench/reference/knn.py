"""The plain reference of the k-NN search and the comparison that decides a
run's `correct`, in plain PyTorch (float32, TF32 off), in blocks.

The program under test returns, for each of the 2R rows, k neighbor
indices and cosine distances sorted ascending, on the u16 wire (distances
snapped to steps of 1 / 32767.5). judge() compares a sample of those
answers with the reference, computed again from the generator's rows, on
the numbers a cell's limits name:

- dist_err: the largest gap between a returned distance and the
  reference's cosine distance of the same (query, neighbor) pair; an
  index out of range or unset (-1), an index twice in a row, or a row
  whose distances are not finite and ascending, reads BROKEN.
- rank_gap (exact search): the largest amount by which the reference's
  k-th best score of a query exceeds the reference's score of the worst
  neighbor the program returned for it; a list that leaves out a better
  candidate for a worse one reads that gap.
- exact_miss (IVF search): the share of the reference's exact top k that
  the lists leave out, averaged over the query rows: a listed neighbor
  counts as one of the top k where its reference score is at least the
  k-th best less TIE. The IVF misses some by design; a search that drops
  members of a cluster, keeps the wrong top k of one, or probes fewer
  clusters misses more.

control_search() is the control that the comparison must fail: the same
exact search with the rows rounded to fp8 (e4m3), the precision below the
bf16 the configurations state.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# the reading of a broken answer (an index out of range, unset or twice in
# a row, or a row out of order)
BROKEN = 1e9
# the u16 wire's distance step (--knn-transfer u16)
DIST_SCALE = 32767.5
# exact_miss: a listed neighbor this close below the reference's k-th best
# score is a tie, not a miss (two float32 sums of one product in another
# order differ by ~1e-7 on unit rows)
TIE = 1e-5


@contextlib.contextmanager
def no_tf32(off: bool = True):
    """float32 products in float32 on a card (TF32 off), or, with off
    False, TF32 on; restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = not off
    torch.backends.cudnn.allow_tf32 = not off
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def unit_rows(rows: torch.Tensor) -> torch.Tensor:
    """L2-normalized float32 rows; a zero row stays zero."""
    rows = rows.to(torch.float32)
    norm = torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    return rows / torch.where(norm == 0, 1.0, norm)


def snap_u16(dist: torch.Tensor) -> torch.Tensor:
    """Distances on the u16 wire's grid."""
    return (torch.round(dist * DIST_SCALE).clamp(0, 65535)
            * np.float32(1.0 / DIST_SCALE))


def pair_scores(unit: torch.Tensor, queries: torch.Tensor,
                idx: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """(Q, k) float32 cosine scores of each query row with each of its
    listed rows (idx clamped into range; the caller judges the range)."""
    idx = idx.clamp(0, unit.shape[0] - 1)
    out = torch.empty(idx.shape, dtype=torch.float32, device=unit.device)
    with no_tf32():
        for q0 in range(0, queries.shape[0], block):
            q = unit[queries[q0 : q0 + block]]
            c = unit[idx[q0 : q0 + block]]
            out[q0 : q0 + block] = torch.bmm(c, q.unsqueeze(2)).squeeze(2)
    return out


def kth_scores(unit: torch.Tensor, queries: torch.Tensor, k: int,
               block: int = 128) -> torch.Tensor:
    """(Q,) the k-th best cosine score of each query row over every row
    (itself included), float32 products summed in float32."""
    out = torch.empty(queries.shape[0], dtype=torch.float32,
                      device=unit.device)
    with no_tf32():
        for q0 in range(0, queries.shape[0], block):
            s = unit[queries[q0 : q0 + block]] @ unit.T
            out[q0 : q0 + block] = torch.topk(s, k, dim=1).values[:, -1]
            del s
    return out


def broken_rows(idx: torch.Tensor, dist: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(Q,) bool: rows with an index out of range or unset, an index twice,
    or distances out of ascending order (or not finite)."""
    bad = ((idx < 0) | (idx >= n_rows)).any(1)
    srt = torch.sort(idx, dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= (dist[:, 1:] < dist[:, :-1]).any(1)
    bad |= ~torch.isfinite(dist).all(1)
    return bad


def judge(rows: torch.Tensor, queries, idx, dist, k: int, names,
          unit: torch.Tensor | None = None) -> dict:
    """The compared numbers `names` (of dist_err, rank_gap, exact_miss) of
    the program's answers for query rows `queries` (Q,): idx (Q, k)
    indices and dist (Q, k) distances (numpy or torch), against the
    reference over `rows` (2R, d). `unit` is unit_rows(rows) where the
    caller has it. A broken answer reads BROKEN in every number."""
    dev = rows.device
    names = set(names)
    unit = unit_rows(rows) if unit is None else unit
    q = torch.as_tensor(queries, device=dev).long()
    idx = torch.as_tensor(idx).to(dev).long()
    dist = torch.as_tensor(dist).to(dev).float()
    if idx.shape != (q.shape[0], k) or dist.shape != idx.shape or bool(
            broken_rows(idx, dist, rows.shape[0]).any()):
        return dict.fromkeys(names, BROKEN)
    if not q.shape[0]:
        return dict.fromkeys(names, 0.0)
    scores = pair_scores(unit, q, idx)
    out = {"dist_err": float((dist - (1.0 - scores)).abs().max())}
    if names & {"rank_gap", "exact_miss"}:
        kth = kth_scores(unit, q, k)
        out["rank_gap"] = max(0.0, float((kth - scores.amin(1)).max()))
        hits = (scores >= (kth - TIE).unsqueeze(1)).sum(1).clamp(max=k)
        out["exact_miss"] = float(1.0 - hits.double().mean() / k)
    return {n: out[n] for n in names}


def merge_readings(parts: list[dict]) -> dict:
    """The largest reading of each number over several judged parts."""
    out: dict = {}
    for part in parts:
        for name, value in part.items():
            out[name] = max(out.get(name, 0.0), value)
    return out


def control_search(rows: torch.Tensor, queries: torch.Tensor, k: int,
                   block: int = 128):
    """The control: the exact search of query rows `queries` over every
    row with the normalized rows rounded to fp8 (e4m3), products summed in
    float32; distances on the u16 grid (the comparison reads scores, so
    the order of equal scores does not matter). An e4m3 value is exact in
    TF32, so a card's TF32 products are the float32 ones. Returns
    (indices (Q, k) int64, distances (Q, k) float32) on the rows' device."""
    unit = unit_rows(rows).to(torch.float8_e4m3fn).to(torch.float32)
    idx = torch.empty((queries.shape[0], k), dtype=torch.int64,
                      device=rows.device)
    dist = torch.empty((queries.shape[0], k), dtype=torch.float32,
                       device=rows.device)
    with no_tf32(False):
        for q0 in range(0, queries.shape[0], block):
            s = unit[queries[q0 : q0 + block]] @ unit.T
            top = torch.topk(s, k, dim=1)
            idx[q0 : q0 + block] = top.indices
            dist[q0 : q0 + block] = snap_u16(1.0 - top.values)
            del s, top
    return idx, dist
