"""Embedding: staged slots -> fwd/rev rows of the (2N, d) embedding matrix,
and kernel C in its two forms (`membership_embed` over the sign table,
`membership_embed_dense` over a dense paired table).

E_fwd[r] = sum over the read's distinct library hits f of P[f]; the
reverse-complement row mirrors f <-> f+L, so E_rev[r] sums P[mirror(f)].
With a paired table (srp.build_precompute_signs or
srp.build_precompute_paired), a hit on library entry j adds [P[j] | P[j+L]]
to (fwd, rev), halves swapped when the window was the reverse strand.
Zero-hit reads embed as exact zero rows.
"""

from __future__ import annotations

import dataclasses

import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.kmers.membership import _pow2, read_hits_staged

# hits summed per slice in the plain versions: the slice width of the JAX
# package's embed_hits_paired(_signs), so that the float32 sums match
_HIT_CHUNK = 128

# Kernel C's dense form sweeps the library (csrc/membership_embed.cu
# dense_sweep_kernel): `parts` warps (at most DENSE_PARTS_MAX) sum one
# staged row in registers, DENSE_COLS columns a chunk (16 of each half a
# lane), in blocks of DENSE_BLOCK_WARPS warps; at the sweep's 128 registers
# a card holds DENSE_WARPS_PER_SM of them an SM, and more parts a row
# shorten each warp's chain of dependent loads where the rows are too few
# to fill them. The library goes in windows of about
# DENSE_WINDOW_BYTES[itemsize] of a chunk's table columns, a block at most
# DENSE_LAG windows ahead of the slowest. The sizes are the fastest that
# timings of the main path's chunk on an H100 found (PERF.md): smaller
# windows pace the blocks more often, larger ones fall out of the 50 MB L2
# (float32) or pay less pacing for rows half as wide (bfloat16).
DENSE_COLS = 512
DENSE_BLOCK_WARPS = 4
DENSE_WARPS_PER_SM = 16
DENSE_PARTS_MAX = 4
DENSE_WINDOW_BYTES = {4: 16 << 20, 2: 32 << 20}
DENSE_LAG = 2


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """The dense sweep's schedule: `rows` staged rows a block, `parts`
    warps a row, `per` table entries a load, the library in `windows`
    windows of `window` rows, a block at most `lag` windows ahead of the
    slowest (none where lag reaches the sweep's steps)."""
    rows: int
    parts: int
    per: int
    window: int
    windows: int
    lag: int


def dense_plan(rows: int, d: int, itemsize: int, lib_size: int, sms: int,
               aligned: bool = True, window: int | None = None,
               lag: int | None = None) -> DensePlan:
    """The dense sweep's plan for `rows` staged rows, d columns, a table of
    itemsize-byte entries (4 float32, 2 bfloat16) whose base is 16-byte
    aligned or not, lib_size library rows, on a card of sms SMs: `per` the
    widest load of 16, 8 or 4 bytes of entries that divides d (one entry
    for a table off 16 bytes); `parts` doubled (up to DENSE_PARTS_MAX)
    while the rows' warps stay within half of what the card holds; `rows`
    a block the rest of DENSE_BLOCK_WARPS; `window` (unless given) the
    library rows whose chunk columns take DENSE_WINDOW_BYTES[itemsize];
    `lag` DENSE_LAG unless given."""
    per = 1
    if aligned:
        for p in (16 // itemsize, 8 // itemsize, 4 // itemsize):
            if p >= 1 and d % p == 0:
                per = p
                break
    parts = 1
    while parts < DENSE_PARTS_MAX and \
            2 * rows * parts <= sms * DENSE_WARPS_PER_SM:
        parts *= 2
    if window is None:
        window = max(1, DENSE_WINDOW_BYTES[itemsize]
                     // (2 * min(d, DENSE_COLS) * itemsize))
    return DensePlan(rows=max(1, DENSE_BLOCK_WARPS // parts), parts=parts,
                     per=per, window=window,
                     windows=max(1, -(-lib_size // window)),
                     lag=DENSE_LAG if lag is None else lag)


def _unpack_sign_rows(words: torch.Tensor, two_d: int) -> torch.Tensor:
    """(..., n_words) int32 sign words -> (..., 2d) float32 in {-1, 0, 1}."""
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=words.device)
    fields = (words[..., None] >> shifts) & 3
    vals = (fields == 1).to(torch.float32) - (fields == 2).to(torch.float32)
    return vals.reshape(*words.shape[:-1], -1)[..., :two_d]


def embed_hits_paired_signs(hits: torch.Tensor, signs: torch.Tensor,
                            mags: torch.Tensor, lib_size: int, d: int):
    """(fwd, rev) (R, d) float32 embeddings of feature rows hits (R, H)
    (sentinel 2L = no hit), summed over _HIT_CHUNK-wide slices in the JAX
    package's sum/difference basis: u = sum(gl + gr), v = sum(+-(gl - gr)),
    fwd = (u + v) / 2, rev = (u - v) / 2."""
    r, h = hits.shape
    swap = hits >= lib_size
    j = torch.where(swap, hits - lib_size, hits)  # sentinel -> zero row L
    u = torch.zeros((r, d), dtype=torch.float32, device=hits.device)
    v = torch.zeros_like(u)
    for s in range(0, h, _HIT_CHUNK):
        jb, sb = j[:, s : s + _HIT_CHUNK], swap[:, s : s + _HIT_CHUNK]
        vals = _unpack_sign_rows(signs[jb], 2 * d) * mags[jb][..., None]
        gl, gr = vals[..., :d], vals[..., d:]
        sign = torch.where(sb, -1.0, 1.0)[..., None]
        u += (gl + gr).sum(dim=1)
        v += ((gl - gr) * sign).sum(dim=1)
    return (u + v) * 0.5, (u - v) * 0.5


def embed_hits_paired(hits: torch.Tensor, p_pair: torch.Tensor,
                      lib_size: int):
    """(fwd, rev) (R, d) float32 embeddings of feature rows hits (R, H)
    (sentinel 2L = no hit) from a dense paired table p_pair (L+1, 2d),
    float32 or bfloat16, summed over _HIT_CHUNK-wide slices in the JAX
    package's sum/difference basis: gl + gr and +-(gl - gr) are formed in
    the table's dtype, then summed in float32. With a bfloat16 table that
    rounds where both halves of a column are nonzero and differ in
    magnitude; the tables srp.build_precompute_paired builds give both
    halves of a row one magnitude, so there the sum and the difference are
    exact."""
    r, h = hits.shape
    d = p_pair.shape[1] // 2
    swap = hits >= lib_size
    j = torch.where(swap, hits - lib_size, hits)  # sentinel -> zero row L
    u = torch.zeros((r, d), dtype=torch.float32, device=hits.device)
    v = torch.zeros_like(u)
    for s in range(0, h, _HIT_CHUNK):
        g = p_pair[j[:, s : s + _HIT_CHUNK]]
        gl, gr = g[..., :d], g[..., d:]
        sign = torch.where(swap[:, s : s + _HIT_CHUNK], -1.0, 1.0).to(
            p_pair.dtype)[..., None]
        u += (gl + gr).sum(dim=1, dtype=torch.float32)
        v += ((gl - gr) * sign).sum(dim=1, dtype=torch.float32)
    return (u + v) * 0.5, (u - v) * 0.5


def _scatter(fwd, rev, targets, out):
    for col, rows in ((0, fwd), (1, rev)):
        t = targets[:, col]
        keep = t >= 0
        out[t[keep]] = rows[keep]


def _membership_embed_plain(staged, lib_codes, signs, mags, targets, out):
    hits, n_hits = read_hits_staged(staged, lib_codes)
    _scatter(*embed_hits_paired_signs(hits, signs, mags, lib_codes.shape[0],
                                      out.shape[1]), targets, out)
    return n_hits


def _membership_embed_dense_plain(staged, lib_codes, p_pair, targets, out):
    hits, n_hits = read_hits_staged(staged, lib_codes)
    _scatter(*embed_hits_paired(hits, p_pair, lib_codes.shape[0]), targets,
             out)
    return n_hits


def _check_rows(staged, lib_codes, targets, out, *tables):
    """Checks both forms share; returns the device type."""
    r = staged.shape[0]
    if staged.dtype != torch.int64 or lib_codes.dtype != torch.int64:
        raise ValueError("staged and lib_codes must be int64")
    if targets.dtype != torch.int64 or targets.shape != (r, 2):
        raise ValueError(f"targets must be int64 of shape {(r, 2)}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise ValueError("out must be a 2-D float32 tensor")
    if any(t.device != out.device
           for t in (staged, lib_codes, targets, *tables)):
        raise ValueError("all tensors must be on one device")
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {out.device}")
    if out.device.type == "cuda":
        if lib_codes.shape[0] >= 2**31:
            raise ValueError("library size must be below 2^31")
        if not out.is_contiguous():
            raise ValueError("out must be contiguous")
    return out.device.type


def _launch_c(name, staged, lib_codes, targets, out, *table_args,
              dense: DensePlan | None = None):
    """One launch of kernel C's C entry `name` (the prefix table, then one
    block per staged row; for the dense form, then the sweep of `dense`,
    with its scratch); table_args sit between the library and d."""
    r, h = staged.shape
    lib_size = lib_codes.shape[0]
    staged, lib_codes, targets = (t.contiguous()
                                  for t in (staged, lib_codes, targets))
    n_hits = torch.empty((r,), dtype=torch.int32, device=out.device)
    # the kernel's prefix table of the library (scratch it rebuilds)
    n_buckets = _pow2(lib_size)
    start = torch.empty((n_buckets + 1,), dtype=torch.int32,
                        device=out.device)
    sweep = ()
    if dense is not None:
        # each row's hits, its window bounds, the sweep's step counters: one
        # allocation
        sizes = (r * h, r * (dense.windows + 1),
                 -(-out.shape[1] // DENSE_COLS) * dense.windows)
        scratch = torch.empty(sum(sizes), dtype=torch.int32,
                              device=out.device)
        offsets = (0, sizes[0], sizes[0] + sizes[1])
        sweep = (*(scratch[o:].data_ptr() for o in offsets), dense.rows,
                 dense.parts, dense.per, dense.window, dense.windows,
                 dense.lag)
    _build.launch(name, staged.data_ptr(), r, h, lib_codes.data_ptr(),
                  lib_size, *table_args, out.shape[1], targets.data_ptr(),
                  out.data_ptr(), n_hits.data_ptr(), start.data_ptr(),
                  n_buckets, *sweep, device=out.device)
    return n_hits


def membership_embed(staged: torch.Tensor, lib_codes: torch.Tensor,
                     signs: torch.Tensor, mags: torch.Tensor,
                     targets: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Fused membership + paired embedding of staged rows (R, H) int64 into
    out (rows, d) float32, in place: row r's fwd embedding goes to row
    targets[r, 0] and its rev embedding to row targets[r, 1] (-1 = do not
    write). Returns n_hits (R,) int32, the distinct library hits per row.

    A CPU tensor takes the plain PyTorch version (read_hits_staged then
    embed_hits_paired_signs, scattered); a CUDA tensor launches kernel C
    (csrc/membership_embed.cu: a prefix table of the library, then the
    lookups and sums)."""
    lib_size = lib_codes.shape[0]
    n_words = (2 * out.shape[1] + 15) // 16
    if signs.dtype != torch.int32 or signs.shape != (lib_size + 1, n_words):
        raise ValueError(f"signs must be int32 of shape {(lib_size + 1, n_words)}")
    if mags.dtype != torch.float32 or mags.shape != (lib_size + 1,):
        raise ValueError(f"mags must be float32 of shape {(lib_size + 1,)}")
    if _check_rows(staged, lib_codes, targets, out, signs, mags) == "cpu":
        return _membership_embed_plain(staged, lib_codes, signs, mags,
                                       targets, out)
    signs, mags = signs.contiguous(), mags.contiguous()
    n_hits = _launch_c("fk_membership_embed", staged, lib_codes, targets,
                       out, signs.data_ptr(), n_words, mags.data_ptr())
    membership_embed.launches += 1
    return n_hits


membership_embed.launches = 0


def membership_embed_dense(staged: torch.Tensor, lib_codes: torch.Tensor,
                           p_pair: torch.Tensor, targets: torch.Tensor,
                           out: torch.Tensor, *,
                           plan: DensePlan | None = None) -> torch.Tensor:
    """membership_embed over a dense paired table p_pair (L+1, 2d), float32
    or bfloat16 (srp.build_precompute_paired, or an imported projection
    through srp.pair_projection): row j = [P[j] | P[j+L]], row L zero.
    The staged rows are sorted, as every staging path writes them.

    A CPU tensor takes the plain PyTorch version (read_hits_staged then
    embed_hits_paired, scattered); a CUDA tensor launches kernel C's dense
    form (csrc/membership_embed.cu `fk_membership_embed_dense`: the same
    prefix table and lookups, each row's hits and window bounds, then the
    sweep of the library that sums each hit's table row into the fwd and
    rev rows in float32, in slot order), on `plan` (dense_plan for the
    card when None)."""
    lib_size = lib_codes.shape[0]
    shape = (lib_size + 1, 2 * out.shape[1])
    if p_pair.dtype not in (torch.float32, torch.bfloat16) \
            or p_pair.shape != shape:
        raise ValueError(f"p_pair must be float32 or bfloat16 of shape "
                         f"{shape}")
    if _check_rows(staged, lib_codes, targets, out, p_pair) == "cpu":
        return _membership_embed_dense_plain(staged, lib_codes, p_pair,
                                             targets, out)
    p_pair = p_pair.contiguous()
    if plan is None:
        from fedrann_tpu_torch.knn.topk import sm_count

        plan = dense_plan(staged.shape[0], out.shape[1],
                          p_pair.element_size(), lib_size,
                          sm_count(out.device), p_pair.data_ptr() % 16 == 0)
    n_hits = _launch_c("fk_membership_embed_dense", staged, lib_codes,
                       targets, out, p_pair.data_ptr(),
                       int(p_pair.dtype == torch.bfloat16), dense=plan)
    membership_embed_dense.launches += 1
    return n_hits


membership_embed_dense.launches = 0


# A projection is a dense paired table (a tensor) or the sign table
# (signs, mags); only the three functions below tell the two apart.


def projection_width(proj, d: int) -> int:
    """The embedding width of the projection `proj`: a dense paired table's
    half width, else d (the sign table packs its 2d fields into 16-field
    words, so it does not hold d itself)."""
    return proj.shape[1] // 2 if isinstance(proj, torch.Tensor) else d


def embed_staged(staged: torch.Tensor, lib_codes: torch.Tensor, proj,
                 targets: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Kernel C in the form of the projection `proj`."""
    if isinstance(proj, torch.Tensor):
        return membership_embed_dense(staged, lib_codes, proj, targets, out)
    return membership_embed(staged, lib_codes, *proj, targets, out)


def embed_hits(hits: torch.Tensor, proj, lib_size: int, d: int):
    """The plain (fwd, rev) embeddings of feature rows hits (R, H) in the
    form of the projection `proj` (embed_hits_paired or
    embed_hits_paired_signs)."""
    if isinstance(proj, torch.Tensor):
        return embed_hits_paired(hits, proj, lib_size)
    return embed_hits_paired_signs(hits, *proj, lib_size, d)
