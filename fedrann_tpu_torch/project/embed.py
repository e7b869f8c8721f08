"""Embedding: staged slots -> fwd/rev rows of the (2N, d) embedding matrix,
and kernel C (`membership_embed`).

E_fwd[r] = sum over the read's distinct library hits f of P[f]; the
reverse-complement row mirrors f <-> f+L, so E_rev[r] sums P[mirror(f)].
With the paired sign table (srp.build_precompute_signs), a hit on library
entry j adds [P[j] | P[j+L]] to (fwd, rev), halves swapped when the window
was the reverse strand. Zero-hit reads embed as exact zero rows.
"""

from __future__ import annotations

import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.kmers.membership import _pow2, read_hits_staged


def _unpack_sign_rows(words: torch.Tensor, two_d: int) -> torch.Tensor:
    """(..., n_words) int32 sign words -> (..., 2d) float32 in {-1, 0, 1}."""
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=words.device)
    fields = (words[..., None] >> shifts) & 3
    vals = (fields == 1).to(torch.float32) - (fields == 2).to(torch.float32)
    return vals.reshape(*words.shape[:-1], -1)[..., :two_d]


def embed_hits_paired_signs(hits: torch.Tensor, signs: torch.Tensor,
                            mags: torch.Tensor, lib_size: int, d: int,
                            hit_chunk: int = 128):
    """(fwd, rev) (R, d) float32 embeddings of feature rows hits (R, H)
    (sentinel 2L = no hit), summed over hit_chunk-wide slices in the JAX
    package's sum/difference basis: u = sum(gl + gr), v = sum(+-(gl - gr)),
    fwd = (u + v) / 2, rev = (u - v) / 2."""
    r, h = hits.shape
    swap = hits >= lib_size
    j = torch.where(swap, hits - lib_size, hits)  # sentinel -> zero row L
    u = torch.zeros((r, d), dtype=torch.float32, device=hits.device)
    v = torch.zeros_like(u)
    for s in range(0, h, hit_chunk):
        jb, sb = j[:, s : s + hit_chunk], swap[:, s : s + hit_chunk]
        vals = _unpack_sign_rows(signs[jb], 2 * d) * mags[jb][..., None]
        gl, gr = vals[..., :d], vals[..., d:]
        sign = torch.where(sb, -1.0, 1.0)[..., None]
        u += (gl + gr).sum(dim=1)
        v += ((gl - gr) * sign).sum(dim=1)
    return (u + v) * 0.5, (u - v) * 0.5


def _membership_embed_plain(staged, lib_codes, signs, mags, targets, out):
    d = out.shape[1]
    hits, n_hits = read_hits_staged(staged, lib_codes)
    fwd, rev = embed_hits_paired_signs(hits, signs, mags,
                                       lib_codes.shape[0], d)
    for col, rows in ((0, fwd), (1, rev)):
        t = targets[:, col]
        keep = t >= 0
        out[t[keep]] = rows[keep]
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
    r, h = staged.shape
    lib_size = lib_codes.shape[0]
    d = out.shape[1]
    n_words = (2 * d + 15) // 16
    if staged.dtype != torch.int64 or lib_codes.dtype != torch.int64:
        raise ValueError("staged and lib_codes must be int64")
    if signs.dtype != torch.int32 or signs.shape != (lib_size + 1, n_words):
        raise ValueError(f"signs must be int32 of shape {(lib_size + 1, n_words)}")
    if mags.dtype != torch.float32 or mags.shape != (lib_size + 1,):
        raise ValueError(f"mags must be float32 of shape {(lib_size + 1,)}")
    if targets.dtype != torch.int64 or targets.shape != (r, 2):
        raise ValueError(f"targets must be int64 of shape {(r, 2)}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise ValueError("out must be a 2-D float32 tensor")
    tensors = (staged, lib_codes, signs, mags, targets, out)
    if any(t.device != out.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if out.device.type == "cpu":
        return _membership_embed_plain(staged, lib_codes, signs, mags,
                                       targets, out)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    if lib_size >= 2**31:
        raise ValueError("library size must be below 2^31")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    staged, lib_codes, signs, mags, targets = (
        t.contiguous() for t in (staged, lib_codes, signs, mags, targets))
    n_hits = torch.empty((r,), dtype=torch.int32, device=out.device)
    # the kernel's prefix table of the library (scratch it rebuilds)
    n_buckets = _pow2(lib_size)
    start = torch.empty((n_buckets + 1,), dtype=torch.int32,
                        device=out.device)
    _build.launch("fk_membership_embed", staged.data_ptr(), r, h,
                  lib_codes.data_ptr(), lib_size, signs.data_ptr(), n_words,
                  mags.data_ptr(), d, targets.data_ptr(), out.data_ptr(),
                  n_hits.data_ptr(), start.data_ptr(), n_buckets,
                  _build.stream(out.device))
    membership_embed.launches += 1
    return n_hits


membership_embed.launches = 0
