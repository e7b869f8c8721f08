"""overlaps.tsv writer: the same header, row order and number format as
`fedrann_tpu/io/tsv.py`; `write_overlaps_path` writes through the native C
writer, `write_overlaps_tsv` is its plain version.

Six columns (query_name, query_orientation, target_name,
target_orientation, neighbor_rank, distance). Embedding row r is read r//2,
orientation '+' if r is even else '-'. The self row is skipped but keeps
its rank position; the query's own reverse-complement row is kept.
"""

from __future__ import annotations

from typing import IO, Sequence

import numpy as np

from fedrann_tpu_torch.io.native import write_overlaps_matrix_native

HEADER = (
    "query_name\tquery_orientation\ttarget_name\ttarget_orientation"
    "\tneighbor_rank\tdistance\n"
)


def _filter_rows(indices: np.ndarray, distances: np.ndarray,
                 row_offset: int = 0):
    """(query row, target row, rank, distance) of every kept entry, in
    row-major order: self rows and unset (-1) entries dropped. Matrix row
    q is embedding row row_offset + q."""
    n, k = indices.shape
    rows = np.arange(row_offset, row_offset + n)[:, None]
    keep = (indices != rows) & (indices >= 0)
    return (
        np.broadcast_to(rows, indices.shape)[keep],
        indices[keep],
        np.broadcast_to(np.arange(k)[None, :], indices.shape)[keep],
        distances[keep],
    )


def write_overlaps_tsv(
    out: IO[str],
    names: Sequence[str],
    neighbor_indices: np.ndarray,   # (2R, k) int
    neighbor_distances: np.ndarray,  # (2R, k) float
    row_offset: int = 0,
) -> int:
    """Write the overlap table; returns the data rows written. row_offset:
    the embedding row of matrix row 0 (a rank writes only its own query
    rows; names stay global)."""
    out.write(HEADER)
    q_rows, t_rows, ranks, dists = _filter_rows(
        np.asarray(neighbor_indices), np.asarray(neighbor_distances),
        row_offset)
    # one "name\torientation" label per embedding row, built once
    labels = [f"{name}\t{o}" for name in names for o in "+-"]
    out.writelines(
        f"{labels[q]}\t{labels[t]}\t{r}\t{d:.9g}\n"
        for q, t, r, d in zip(q_rows.tolist(), t_rows.tolist(),
                              ranks.tolist(), dists.tolist())
    )
    return len(q_rows)


def write_overlaps_path(path: str, names: Sequence[str],
                        neighbor_indices: np.ndarray,
                        neighbor_distances: np.ndarray,
                        row_offset: int = 0) -> int:
    """Write overlaps.tsv to `path`: the header, then the rows by the
    native C writer (`io/native.py`), the same bytes as
    write_overlaps_tsv, its plain version. Returns the data rows."""
    with open(path, "w") as f:
        f.write(HEADER)
    return write_overlaps_matrix_native(
        path, list(names), np.asarray(neighbor_indices),
        np.asarray(neighbor_distances), row_offset)
