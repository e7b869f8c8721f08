"""Faults planted under the timed path, and the control put in its place,
to show that the comparison that decides `correct` catches them. Each
wraps a job (rows -> (indices, distances)) the way run.run_cell calls it:

- stale: every job after the first returns the previous job's answers
  (a step that returns its state unchanged; the jobs alternate between
  two read sets, so the answers are another read set's);
- half: the search sees half of the batch, the second half of the rows
  zeroed (half of the batch left out);
- altered: each row's last neighbor index is moved to the next row (an
  answer altered where it is produced);
- probes_half (IVF): the search probes half of its p clusters;
- members_half (IVF): each cluster keeps the first half of its members
  (K11's member buckets, or the CPU's member table, cut), so the rest are
  never scored;
- control: the control in the program's place, the exact search with the
  rows rounded to fp8 (reference.knn.control_search) over every row, the
  precision below the configurations' bf16.

ROUTES names the faults that only a search route has (the IVF's own);
the others apply to every cell. One chip holds each cell, so no exchange
between chips can be left out.
"""

from __future__ import annotations

from unittest import mock


def stale(job):
    last = []

    def run(rows):
        out = job(rows) if not last else last[-1]
        last[:] = [out]
        return out

    return run


def half(job):
    def run(rows):
        cut = rows.clone()
        cut[rows.shape[0] // 2 :] = 0
        return job(cut)

    return run


def altered(job):
    def run(rows):
        idx, dist = job(rows)
        idx = idx.copy()
        idx[:, -1] = (idx[:, -1] + 1) % rows.shape[0]
        return idx, dist

    return run


def probes_half(job):
    from fedrann_tpu_torch import pipeline

    real = pipeline.knn_ivf

    def fewer(*args, n_probes, **kwargs):
        return real(*args, n_probes=max(1, n_probes // 2), **kwargs)

    def run(rows):
        with mock.patch.object(pipeline, "knn_ivf", fewer):
            return job(rows)

    return run


def first_half(members, n_rows: int):
    """The members of each cluster cut to their first half (rounded up):
    K11's Buckets on a card, the CPU's (member table, counts) elsewhere,
    its cut entries set to the sentinel row n_rows."""
    import torch

    from fedrann_tpu_torch.knn.ivf import Buckets

    if isinstance(members, Buckets):
        bounds = members.bounds.long()
        counts = bounds[1:] - bounds[:-1]
        keep = (counts + 1) // 2
        cluster = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=bounds.device), counts)
        at = torch.arange(cluster.shape[0], device=bounds.device) \
            - bounds[:-1][cluster]
        cut = torch.zeros_like(bounds)
        cut[1:] = torch.cumsum(keep, 0)
        return Buckets(members.vals[at < keep[cluster]].contiguous(),
                       cut.int())
    table, counts_h = members
    keep = torch.from_numpy((counts_h + 1) // 2).to(table.device)
    table = table.clone()
    table[torch.arange(table.shape[1], device=table.device)[None, :]
          >= keep[:, None]] = n_rows
    return table, counts_h


def members_half(job):
    from fedrann_tpu_torch.knn import ivf

    real = ivf._member_side

    def side(a, c, spill):
        return first_half(real(a, c, spill), a.shape[0] // spill)

    def run(rows):
        with mock.patch.object(ivf, "_member_side", side):
            return job(rows)

    return run


def control(job):
    def run(rows):
        import torch

        from portbench.reference.knn import control_search

        k = min(job.config.n_neighbors, rows.shape[0])
        idx, dist = control_search(
            rows, torch.arange(rows.shape[0], device=rows.device), k,
            block=1024)
        return (idx.to(torch.int32).cpu().numpy(),
                dist.cpu().numpy())

    return run


FAULTS = {"stale": stale, "half": half, "altered": altered,
          "probes_half": probes_half, "members_half": members_half,
          "control": control}
ROUTES = {"probes_half": "ivf", "members_half": "ivf"}


def applies(fault: str, route: str) -> bool:
    """Whether a search on `route` ("exact", "ivf", ...) can have `fault`."""
    return fault not in ROUTES or route.startswith(ROUTES[fault])
